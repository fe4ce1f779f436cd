"""The parallel modes: the process mesh, data parallelism, FSDP, tensor
and sequence parallelism (``mesh``) and the pipeline (``pipeline``)."""
