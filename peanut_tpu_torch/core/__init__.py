"""Infrastructure (port of ``peanut_tpu.core``): training checkpoints and
the python config-file loader of the model zoo.  The mesh is ROADMAP A14."""
