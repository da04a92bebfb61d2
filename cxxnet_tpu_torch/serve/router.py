"""Per-model dispatch: a request's ``model`` field picks a served model.

The port's copy of the first part of ``cxxnet_tpu/serve/router.py``:
:class:`UnknownModelError` and :class:`ModelRouter`, which the HTTP
front-end (``serve/server.py``, ``router=``) and the multi-tenant loop
manager (``loop/tenant.py``, ``task=loop_fleet``) resolve through.  The
rest of that file, the serving fleet's front door (``_ReplicaPool``,
``FleetStats``, ``FleetRouter``), comes with the fleet itself
(ROADMAP.md queue A item (i)); this module imports nothing of it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["ModelRouter", "UnknownModelError"]


class UnknownModelError(KeyError):
    """A request named a model no route serves.  ``reason`` is the
    stable machine-readable token clients and supervisors key on (the
    HTTP layer maps this to a 404 carrying it)."""

    reason = "unknown_model"

    def __init__(self, model, known) -> None:
        self.model = model
        self.known = sorted(known)
        super().__init__(
            f"unknown model {model!r}; serving: "
            f"{', '.join(self.known) or '(none)'}")

    def __str__(self) -> str:  # KeyError.__str__ repr()s its arg
        return self.args[0]


class ModelRouter:
    """Per-model dispatch: a request's ``model`` field → the named
    tenant's engine and feedback log.

    A model-less request takes the DEFAULT route — the first model
    registered, or the one flagged ``default`` — so single-model
    clients keep working against a multi-model server.  Routes are
    fixed after startup, so resolution takes no lock."""

    def __init__(self) -> None:
        self._routes: Dict[str, Tuple[object, object]] = {}
        self._default: Optional[str] = None

    def add(self, name: str, engine, feedback=None,
            default: bool = False) -> "ModelRouter":
        if not name:
            raise ValueError("a model route needs a non-empty name")
        if name in self._routes:
            raise ValueError(f"duplicate model route {name!r}")
        self._routes[name] = (engine, feedback)
        if default or self._default is None:
            self._default = name
        return self

    def resolve(self, model=None) -> Tuple[str, object, object]:
        """``(name, engine, feedback)`` for a request's ``model`` field
        (None or empty → the default route).  Raises
        :class:`UnknownModelError` for a name no route serves."""
        if model in (None, ""):
            model = self._default
        if model not in self._routes:
            raise UnknownModelError(model, self._routes.keys())
        engine, feedback = self._routes[model]
        return str(model), engine, feedback

    def models(self) -> List[str]:
        return sorted(self._routes)

    def engines(self) -> List[object]:
        return [e for e, _fb in self._routes.values()]

    def healthz_models(self) -> Dict[str, dict]:
        """Per-model identity block for the front-end's ``/healthz``."""
        out = {}
        for name, (engine, _fb) in sorted(self._routes.items()):
            h = engine.healthz()
            out[name] = {"status": h.get("status"),
                         "round": h.get("round"),
                         "model_crc32": h.get("model_crc32"),
                         "default": name == self._default}
        return out
