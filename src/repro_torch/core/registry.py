"""Generic name -> object registry shared by every extension seam.

Port of ``repro/core/registry.py``.  One :class:`Registry` owns key
normalization, duplicate checking, alias registration, the override
sweep (replacing a name also drops any *other* alias still bound to the
replaced object, so a stale alias can never resolve the old entry), and
unregistration.  Each seam keeps its own decorator/getter functions and
error messages; the per-registry texture is injected through the
constructor:

  * ``kind``      — noun used in error messages ("codec", ...).
  * ``key_fn``    — name normalization (enum members -> their value).
  * ``prepare``   — turn the decorated object into the stored value.
  * ``describe``  — how an existing entry is named in the duplicate error.
  * ``register_hint`` / ``format_available`` — the unknown-name error's
    trailing hint and how the available-names list renders.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

__all__ = ["Registry"]


def _default_prepare(obj: Any, keys: Sequence[str]) -> Any:
    return obj


def _default_describe(value: Any) -> str:
    return type(value).__name__


class Registry:
    """One extension seam: normalized string keys -> registered values."""

    def __init__(self, kind: str, *,
                 key_fn: Callable[[Any], str] = str,
                 prepare: Callable[[Any, Sequence[str]], Any] | None = None,
                 describe: Callable[[Any], str] | None = None,
                 register_hint: str | None = None,
                 format_available: Callable[[tuple], str] = repr):
        self.kind = kind
        self.key_fn = key_fn
        self.prepare = prepare or _default_prepare
        self.describe = describe or _default_describe
        #: e.g. ``"@register_codec({key!r})"`` — appended to unknown-name
        #: errors as "Register one with <hint>."; None omits the hint.
        self.register_hint = register_hint
        self.format_available = format_available
        self._items: dict[str, Any] = {}

    # -- registration ----------------------------------------------------

    def register(self, name: Any, *aliases: Any, override: bool = False):
        """Decorator registering an object under ``name`` (+ ``aliases``).

        Re-registering an existing key raises unless ``override=True``,
        which replaces the named keys *and* sweeps any other alias still
        bound to the replaced values.  Returns the decorated object
        unchanged (classes stay usable as classes).
        """
        keys = [self.key_fn(k) for k in (name, *aliases)]

        def deco(obj):
            value = self.prepare(obj, keys)
            if not override:
                # validate every key before inserting any, so a clash on
                # an alias cannot leave the registry half-registered
                for key in keys:
                    if key in self._items:
                        raise ValueError(
                            f"{self.kind} {key!r} already registered "
                            f"({self.describe(self._items[key])}); pass "
                            f"override=True to replace it")
            else:
                replaced = {id(self._items[k]): self._items[k]
                            for k in keys if k in self._items}
                for old in replaced.values():
                    if old is not value:
                        for k in [k for k, v in self._items.items()
                                  if v is old]:
                            del self._items[k]
            for key in keys:
                self._items[key] = value
            return obj

        return deco

    def unregister(self, name: Any) -> None:
        """Remove an entry and every alias bound to the same value
        (primarily for tests tearing down toy registrations)."""
        value = self._items.pop(self.key_fn(name), None)
        if value is not None:
            for key in [k for k, v in self._items.items() if v is value]:
                del self._items[key]

    # -- resolution ------------------------------------------------------

    def get(self, name: Any) -> Any:
        """Resolve a registered name to its stored value."""
        key = self.key_fn(name)
        try:
            return self._items[key]
        except KeyError:
            msg = (f"unknown {self.kind} {key!r}; available: "
                   f"{self.format_available(self.available())}")
            if self.register_hint is not None:
                msg += (". Register one with "
                        f"{self.register_hint.format(key=key)}.")
            raise KeyError(msg) from None

    def available(self) -> tuple[str, ...]:
        return tuple(sorted(self._items))

    def __contains__(self, name: Any) -> bool:
        return self.key_fn(name) in self._items

    def __len__(self) -> int:
        return len(self._items)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Registry({self.kind!r}, {len(self._items)} entries)"
