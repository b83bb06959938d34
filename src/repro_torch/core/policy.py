"""Name -> object registry shared by the port's scheduling domains.

Port of ``Registry`` from ``repro/core/policy.py``. The rest of that module
(the ``MemoryPolicy`` protocol and the cycle-sim step) belongs to the
simulator and is not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple


class Registry:
    """Ordered name -> object registry with a decorator interface.

    Mapping-style access (`reg["sms"]`, `reg["sms"] = obj`, `"sms" in reg`,
    `reg.keys()`) is supported so call sites and tests can treat a registry
    like the plain dicts it replaces.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: Optional[str] = None) -> Callable:
        """Use as ``@reg.register("name")`` or ``@reg.register`` (reads
        the object's ``name`` attribute)."""
        def deco(obj, _name=name if isinstance(name, str) else None):
            key = _name or getattr(obj, "name", None)
            if not key:
                raise ValueError(f"{self.kind} needs a `name` to register")
            if key in self._entries:
                raise ValueError(f"duplicate {self.kind} {key!r}")
            self._entries[key] = obj
            return obj

        if name is None or isinstance(name, str):
            return deco
        return deco(name)                       # bare @reg.register on a class

    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"unknown {self.kind} {name!r}; "
                           f"registered: {', '.join(self._entries)}") from None

    def names(self) -> Tuple[str, ...]:
        return tuple(self._entries)

    def keys(self):
        return self._entries.keys()

    def items(self):
        return self._entries.items()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def __setitem__(self, name: str, obj: Any) -> None:
        self._entries[name] = obj               # tests swap entries in-place
