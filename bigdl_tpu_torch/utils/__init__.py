"""Utilities of the port."""
from bigdl_tpu_torch.utils.convert import (export_opt_state,
                                           export_variables, flatten,
                                           load_jax_opt_state,
                                           load_jax_variables,
                                           random_variables)

__all__ = ["export_opt_state", "export_variables", "flatten",
           "load_jax_opt_state", "load_jax_variables", "random_variables"]
