"""Models of the port: the dense-family language model
(:class:`LanguageModel`), its layers, and the conversion of the
reference's parameter trees (:func:`params_from_jax`)."""

from .convert import params_from_jax
from .layers import RuntimeFlags
from .transformer import LanguageModel

__all__ = ["LanguageModel", "RuntimeFlags", "params_from_jax"]
