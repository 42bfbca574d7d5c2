"""Config tree with YAML loading, ``key=value`` overrides and ``${...}``
interpolation (with ``${add:...}``-style resolvers).

A copy of ``drawingspinup_tpu/core/config.py`` trimmed to what the recon
CLI reads; ``tests/test_torch_recon.py`` pins it to the original.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Union

import yaml

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


class Config(dict):
    """A dict with attribute access and recursive wrapping."""

    def __init__(self, data: Optional[Mapping[str, Any]] = None, **kw: Any):
        super().__init__()
        merged: Dict[str, Any] = dict(data or {})
        merged.update(kw)
        for k, v in merged.items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __setitem__(self, name: str, value: Any) -> None:
        super().__setitem__(name, _wrap(value))

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, list):
                node = node[int(part)]
            elif isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Any = self
        for part in parts[:-1]:
            if isinstance(node, list):
                node = node[int(part)]
            else:
                if part not in node or not isinstance(node[part], (dict, list)):
                    node[part] = Config()
                node = node[part]
        if isinstance(node, list):
            node[int(parts[-1])] = _wrap(value)
        else:
            node[parts[-1]] = _wrap(value)


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def _num(x: Any) -> Union[int, float]:
    if isinstance(x, (int, float)):
        return x
    f = float(x)
    return int(f) if f == int(f) and "." not in str(x) and "e" not in str(x).lower() else f


_RESOLVERS: Dict[str, Callable[..., Any]] = {
    "calc_exp_lr_decay_rate": lambda factor, n: float(factor) ** (1.0 / float(n)),
    "add": lambda a, b: _num(a) + _num(b),
    "sub": lambda a, b: _num(a) - _num(b),
    "mul": lambda a, b: _num(a) * _num(b),
    "div": lambda a, b: _num(a) / _num(b),
}


def _parse_scalar(s: str) -> Any:
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def _resolve_value(root: Config, value: Any, stack: tuple) -> Any:
    if isinstance(value, str):
        return _resolve_str(root, value, stack)
    if isinstance(value, Mapping):
        return Config({k: _resolve_value(root, v, stack) for k, v in value.items()})
    if isinstance(value, list):
        return [_resolve_value(root, v, stack) for v in value]
    return value


def _resolve_str(root: Config, s: str, stack: tuple) -> Any:
    def sub(match: "re.Match[str]") -> str:
        return str(_resolve_expr(root, match.group(1), stack))

    out = s
    for _ in range(10):
        m = _INTERP_RE.fullmatch(out)
        if m:  # whole-string interpolation: preserve the value's type
            return _resolve_expr(root, m.group(1), stack)
        new = _INTERP_RE.sub(sub, out)
        if new == out:
            break
        out = new
    return out


def _resolve_expr(root: Config, expr: str, stack: tuple) -> Any:
    expr = expr.strip()
    if expr in stack:
        raise ValueError(f"circular interpolation: {expr!r} via {stack}")
    if ":" in expr:
        name, _, argstr = expr.partition(":")
        name = name.strip()
        if name in _RESOLVERS:
            args = [_resolve_value(root, _parse_scalar(a.strip()), stack + (expr,))
                    for a in _split_args(argstr)]
            return _RESOLVERS[name](*args)
    ref = root.get_path(expr, _MISSING)
    if ref is _MISSING:
        raise KeyError(f"interpolation target not found: {expr!r}")
    return _resolve_value(root, ref, stack + (expr,))


_MISSING = object()


def _split_args(argstr: str) -> List[str]:
    """Split on top-level commas (respecting ${...} nesting)."""
    args, depth, cur = [], 0, []
    for ch in argstr:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "," and depth == 0:
            args.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        args.append("".join(cur))
    return args


def resolve(cfg: Config) -> Config:
    """A new Config with every ``${...}`` interpolation resolved."""
    return _resolve_value(cfg, cfg, ())  # type: ignore[return-value]


def load_config(path: str, overrides: Optional[Iterable[str]] = None) -> Config:
    """Load a YAML config, apply ``key.path=value`` overrides, resolve
    interpolations."""
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = Config(raw)
    for ov in overrides or []:
        key, _, val = ov.partition("=")
        cfg.set_path(key.strip(), _parse_scalar(val.strip()))
    return resolve(cfg)
