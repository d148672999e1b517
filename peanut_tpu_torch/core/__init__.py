"""Training infrastructure (port of the training half of
``peanut_tpu.core``): checkpoints.  The config-file loader and the mesh are
ROADMAP A13 and A14."""
