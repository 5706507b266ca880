"""Models of the port: the language model of every family of the
reference's configs (:class:`LanguageModel`: dense, MoE, RWKV6, the Mamba
hybrid, the frontend families), its layers (``layers``, ``moe``,
``ssm``), and
the conversion of the reference's parameter trees and training states
(:func:`params_from_jax`, :func:`train_state_from_jax`)."""

from .convert import params_from_jax, train_state_from_jax
from .layers import RuntimeFlags
from .transformer import LanguageModel

__all__ = ["LanguageModel", "RuntimeFlags", "params_from_jax", "train_state_from_jax"]
