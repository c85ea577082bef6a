from .params import params_from_jax, pyramid_from_jax, spec_from_jax

__all__ = ["params_from_jax", "pyramid_from_jax", "spec_from_jax"]
