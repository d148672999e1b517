"""The PEANUT prediction model (PSPNet-R50-v1c): ``build_segmentor`` and
``peanut_prediction_config``, which live in ``models.builder`` and are
re-exported here for the modules that import them from this one."""

from .builder import build_segmentor, peanut_prediction_config

__all__ = ["build_segmentor", "peanut_prediction_config"]
