"""Multi-GPU: the process group and the ``data`` x ``fsdp`` mesh
(``mesh``), frame parallelism of the UNet's temporal stages (``frames``)
and weight-sharded sampling (``weights``)."""
