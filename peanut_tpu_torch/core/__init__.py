"""Infrastructure (port of ``peanut_tpu.core``): training checkpoints, the
python config-file loader of the model zoo, and the device mesh with the
process group (``mesh``: the data axis), and the row-sharded maps of the
mesh's spatial axis (``spatial``)."""
