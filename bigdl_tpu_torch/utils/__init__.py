"""Utilities of the port."""
from bigdl_tpu_torch.utils.convert import (export_opt_state,
                                           export_variables, flatten,
                                           load_jax_opt_state,
                                           load_jax_variables,
                                           random_variables)
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils.serialization import (dumps_pytree, load_model,
                                                 load_pytree, loads_pytree,
                                                 save_model, save_pytree)
from bigdl_tpu_torch.utils.table import T, Table

__all__ = ["dumps_pytree", "export_opt_state", "export_variables",
           "file_io", "flatten", "load_jax_opt_state", "load_jax_variables",
           "load_model", "load_pytree", "loads_pytree", "random_variables",
           "save_model", "save_pytree", "T", "Table"]
