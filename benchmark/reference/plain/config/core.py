"""Layered configuration: defaults tree <- YAML recipe <- CLI dotlist.

Mirrors the reference's OmegaConf three-way merge
(scripts/train_avatar.py:86-91) without the omegaconf dependency (not in
this image): a nested-dict tree with attribute access, deep merge, YAML
or JSON loading, and `key.sub=value` dotlist overrides with literal-eval typing.
"""
from __future__ import annotations

import ast
import copy
import json
from typing import Any


class Config(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(d: Any):
        if isinstance(d, dict):
            return Config({k: Config.wrap(v) for k, v in d.items()})
        if isinstance(d, list):
            return [Config.wrap(v) for v in d]
        return d

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v
        return unwrap(self)


def deep_merge(base: Config, override: dict) -> Config:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = Config.wrap(v)
    return out


def parse_dotlist(items: list[str]) -> dict:
    """['a.b=3', 'c=[1,2]'] -> nested dict with literal-evaled values."""
    root: dict = {}
    for item in items:
        key, _, raw = item.partition("=")
        try:
            val = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            val = raw
        node = root
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _read_tree(path: str) -> dict:
    """A config file's tree: JSON when the text is a JSON object (what
    save_config writes; JSON is also YAML), otherwise YAML, with PyYAML
    imported only then."""
    with open(path) as fh:
        text = fh.read()
    if text.lstrip().startswith("{"):
        return json.loads(text)
    import yaml

    return yaml.safe_load(text) or {}


def load_config(defaults: dict, yaml_path: str | None = None,
                dotlist: list[str] | None = None) -> Config:
    cfg = Config.wrap(defaults)
    if yaml_path:
        # a parser only when a file is given: a config built from
        # DEFAULTS plus a dotlist needs none
        cfg = deep_merge(cfg, _read_tree(yaml_path))
    if dotlist:
        cfg = deep_merge(cfg, parse_dotlist(dotlist))
    return cfg
