"""The port's ``ModelConfig`` for a configuration file: the arch the file's
``port.arch`` names, with ``port.replace`` applied (lists become tuples), then
each field of ``port.same`` held equal to the file's key it names, so that the
program runs the sizes the file states."""

from __future__ import annotations


def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def build(config):
    from repro_torch.configs.registry import get_config
    port = config["port"]
    cfg = get_config(port["arch"])
    replace = {k: _tuples(v) for k, v in port.get("replace", {}).items()}
    if replace:
        cfg = cfg.replace(**replace)
    for field, key in port["same"].items():
        if getattr(cfg, field) != config[key]:
            raise ValueError(f"{port['arch']}: the port's {field} "
                             f"{getattr(cfg, field)!r}, the file's {key} "
                             f"{config[key]!r}")
    return cfg
