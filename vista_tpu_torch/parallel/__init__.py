"""Multi-GPU: the process group and the ``data`` x ``fsdp`` mesh
(``mesh``), frame parallelism of the UNet's temporal stages (``frames``),
sequence parallelism over latent rows (``height``) and weight-sharded
sampling (``weights``)."""
