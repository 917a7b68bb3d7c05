"""Attribute-style dict used for configs.

Drop-in replacement for the `easydict.EasyDict` the reference depends on
(reference: pcdet/config.py:1-5) — reimplemented here because configs are the
one place where attribute access genuinely reads better than indexing.
"""
from __future__ import annotations


class EDict(dict):
    """dict subclass with attribute access; nests on assignment."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        if d is None:
            d = {}
        d = dict(d, **kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, EDict):
            return EDict(v)
        if isinstance(v, (list, tuple)):
            return type(v)(EDict._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, EDict._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def update(self, other=None, **kwargs):
        other = dict(other or {}, **kwargs)
        for k, v in other.items():
            self[k] = v

    def copy(self):
        return EDict(self)


# Alias matching the reference import name so downstream code reads familiarly.
EasyDict = EDict
