"""Pluggable component registries — the toolkit's extension surface.

Asyncval's pitch is a *toolkit*: users plug their own dense-retriever model
and validation sets into an asynchronous validation loop.  Every string-
dispatched component in the validation path — engines (``streaming`` /
``materialized``), stages (the fused encode→fold strategies), samplers (the
paper's splitter variants), encoders, validation modes, and retrieval impls
— resolves through one of the registries below, so third-party code extends
the toolkit by *registering*, never by editing ``repro_torch`` internals:

    from repro_torch.core.registry import register_engine

    @register_engine("my_engine")
    def make_my_engine(spec, store, vcfg):
        return MyEngine(...)

    ValidationConfig(engine="my_engine")      # now just works

Unknown names raise immediately with the sorted list of registered
alternatives (and a did-you-mean hint), both inside the library and at CLI
parse time — a typo'd ``--engine`` fails before any corpus is padded.

Registration is import-time (decorators at module scope), so a registry's
contents reflect which component modules have been imported.  The built-in
components live in :mod:`repro_torch.core.engine` (engines, stages,
modes, impls) and :mod:`repro_torch.core.samplers` (samplers); importing
either populates the corresponding registries.

These are the port's own registry instances, separate from the JAX
package's, so a process that imports both packages sees no clash.
"""

from __future__ import annotations

import difflib
from typing import Any, Dict, List


class Registry:
    """A named string→component table with helpful unknown-name errors.

    Components are arbitrary objects (classes, factory functions, route
    hints).  ``register`` is usable as a decorator or a direct call;
    re-registering a *different* object under a taken name is an error
    unless ``overwrite=True`` (re-importing a module that registers the
    same object is always fine).
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

    # -- registration --------------------------------------------------------
    def register(self, name: str, obj: Any = None, *,
                 overwrite: bool = False):
        """``register("name")`` (decorator) or ``register("name", obj)``."""
        if not name or not isinstance(name, str):
            raise ValueError(f"{self.kind} name must be a non-empty string, "
                             f"got {name!r}")

        def add(o):
            prev = self._items.get(name)
            if prev is not None and prev is not o and not overwrite:
                raise ValueError(
                    f"{self.kind} {name!r} is already registered "
                    f"(pass overwrite=True to replace it)")
            self._items[name] = o
            return o

        return add if obj is None else add(obj)

    # -- lookup --------------------------------------------------------------
    def get(self, name: str) -> Any:
        try:
            return self._items[name]
        except KeyError:
            raise ValueError(self._unknown(name)) from None

    def _unknown(self, name) -> str:
        names = self.names()
        msg = (f"unknown {self.kind} {name!r} "
               f"(registered {self.kind}s: {', '.join(names) or 'none'})")
        close = difflib.get_close_matches(str(name), names, n=1)
        if close:
            msg += f" — did you mean {close[0]!r}?"
        return msg

    def names(self) -> List[str]:
        return sorted(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __len__(self) -> int:
        return len(self._items)

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, {self.names()})"


# ---------------------------------------------------------------------------
# The toolkit's registries.  Built-ins register at import of their defining
# module; `ensure_builtins()` imports those modules for callers (the CLI)
# that need fully-populated name lists before touching the components.
# ---------------------------------------------------------------------------

ENGINES = Registry("engine")      # name -> factory(spec, store, vcfg)
STAGES = Registry("stage")        # name -> factory(encode_fn, **kw) -> Stage
SAMPLERS = Registry("sampler")    # name -> factory(depth=...) -> sampler
ENCODERS = Registry("encoder")    # name -> factory(args) -> EncoderSpec
MODES = Registry("mode")          # name -> route(impl=, mesh=, per_query=)
IMPLS = Registry("impl")          # name -> route(mesh=) -> stage name

register_engine = ENGINES.register
register_stage = STAGES.register
register_sampler = SAMPLERS.register
register_encoder = ENCODERS.register
register_mode = MODES.register
register_impl = IMPLS.register


def ensure_builtins() -> None:
    """Import the modules whose decorators populate the registries with the
    built-in components (idempotent; cheap after the first call)."""
    import repro_torch.core.engine    # noqa: F401  engines, stages, modes
    import repro_torch.core.samplers  # noqa: F401  samplers


def resolve_sampler(sampler: Any, *, depth: int = 0) -> Any:
    """Accept a sampler instance, a registered sampler name, or ``None``
    (→ the ``full`` no-subset sampler).  Names resolve through
    :data:`SAMPLERS`, whose factories take the subset ``depth``."""
    import repro_torch.core.samplers  # noqa: F401  populate SAMPLERS
    if sampler is None:
        return SAMPLERS.get("full")(depth=depth)
    if isinstance(sampler, str):
        return SAMPLERS.get(sampler)(depth=depth)
    return sampler
