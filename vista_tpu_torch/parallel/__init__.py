"""Multi-GPU: the process group and the ``data`` x ``fsdp`` mesh
(``mesh``), frame parallelism of the UNet's temporal stages (``frames``),
sequence parallelism over latent rows (``height``), weight-sharded
sampling (``weights``) and exact sequence-parallel attention with gathered
keys and values (``sp_attention``, which the VideoUNet does not call)."""
