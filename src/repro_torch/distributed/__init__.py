"""Multi-device execution of the port: the planned CNN pipeline
(``pipeline.PipelineExecutor``)."""
