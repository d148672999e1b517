"""Infrastructure (port of ``peanut_tpu.core``): training checkpoints, the
python config-file loader of the model zoo, and the device mesh with the
process group (``mesh``: the data axis; the spatial axis is ROADMAP A14
part 2)."""
