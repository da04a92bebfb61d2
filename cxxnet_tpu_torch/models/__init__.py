"""Conf builders: the byte-level transformer LM (``transformer_lm_conf``)."""

from .builders import transformer_lm_conf  # noqa: F401
