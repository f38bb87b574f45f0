"""Name lookups into the port's registries.  The port carries only what has
been ported so far; asking for anything else (a model, group, landmark
type, ECP or solver variant the JAX package has) raises
``NotImplementedError`` with its name instead of a bare ``KeyError``."""

from __future__ import annotations


def lookup(table, name: str, kind: str):
    try:
        return table[name]
    except KeyError:
        raise NotImplementedError(
            f"{kind} {name!r} is not ported to srba_tpu_torch yet "
            f"(ported: {', '.join(sorted(table))})") from None
