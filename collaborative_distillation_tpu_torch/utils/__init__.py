__all__ = ["params_from_jax", "pyramid_from_jax", "spec_from_jax", "adam_state_to_jax",
           "adam_state_from_jax"]


def __getattr__(name):
    # the parameter helpers load at first use: ops/conv.py imports
    # utils.profiling, and params.py imports models, whose vgg imports ops/conv.py
    if name in __all__:
        from . import params
        return getattr(params, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
