"""Config system: YAML group composition and the Hydra-style override grammar.

Counterpart of avt_tpu/config: conf/config.yaml with its defaults list of
config groups; the overrides key=value, +key=value, group=option,
group@key=option and ~key; ${a.b} interpolation with the resolvers minus,
times_int and cwd; comma sweeps; `_target_` instantiation through a
registry that maps the reference's and the JAX package's target strings
onto the port's classes. YAML is read by the port's own reader, so the
package needs no PyYAML.
"""
from avt_tpu_torch.config.compose import Composer, compose, load_yaml, resolve_interpolations
from avt_tpu_torch.config.overrides import (
    expand_sweeps,
    parse_override,
    parse_overrides_file,
    parse_value,
    yaml_load,
)
from avt_tpu_torch.config.registry import instantiate, register_target, resolve_target

__all__ = [
    "Composer", "compose", "expand_sweeps", "instantiate", "load_yaml", "parse_override",
    "parse_overrides_file", "parse_value", "register_target", "resolve_interpolations",
    "resolve_target", "yaml_load",
]
