from .params import (adam_state_from_jax, adam_state_to_jax, params_from_jax, pyramid_from_jax,
                     spec_from_jax)

__all__ = ["params_from_jax", "pyramid_from_jax", "spec_from_jax", "adam_state_to_jax",
           "adam_state_from_jax"]
