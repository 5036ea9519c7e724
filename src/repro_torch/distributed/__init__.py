"""Multi-device execution of the port: the planned CNN pipeline
(``pipeline.PipelineExecutor``); and the training loop's fault tolerance
(``ft``: heartbeats, failure detection, stragglers, elastic re-mesh
plans)."""
