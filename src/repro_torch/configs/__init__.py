"""Layer tables of the paper's networks, as plain data."""
