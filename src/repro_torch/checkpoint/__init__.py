from repro_torch.checkpoint.store import AsyncCheckpointWriter, CheckpointStore

__all__ = ["AsyncCheckpointWriter", "CheckpointStore"]
