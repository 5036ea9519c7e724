"""Multi-device execution of the port: the planned CNN pipeline
(``pipeline.PipelineExecutor``); the training loop's fault tolerance
(``ft``: heartbeats, failure detection, stragglers, elastic re-mesh
plans); and the LM side: the mesh context and activation hints
(``context``), the partition rules and ZeRO specs (``sharding``), int8
error-feedback gradient compression (``compression``) and the
data-parallel ZeRO train step (``zero``)."""
