"""JAX-free access to the host code the port shares with ``cqs_tpu``.

The port reuses, not copies, the JAX package's host modules: config, store,
parser, nl, utils, native, ``models/tokenizer.py``, ``models/registry.py``,
``index/stamp.py``, ``index/lexical.py``, ``search/router.py``,
``search/scoring.py``, ``search/synonyms.py`` and ``cli/envelope.py``. None of
them imports JAX, but four of their packages do in their ``__init__``:
``cqs_tpu.search`` (the engine), ``cqs_tpu.models`` (the embedder),
``cqs_tpu.index`` (the dense index) and ``cqs_tpu.cli`` (the CLI, which
configures JAX at import).

Unless the reference package was imported first, this module registers those
four as lazy package modules: ``__path__`` is the real directory, so
submodules import without running the ``__init__``; the first access to a
package-level name (``from cqs_tpu.search import SearchEngine``) runs the
real ``__init__`` in the module's namespace. The port only imports
submodules, so it never pulls JAX in, whether or not JAX is installed; code
of the reference package in the same process still sees its full packages.
"""

from __future__ import annotations

import importlib.machinery
import sys
import types
from pathlib import Path

import cqs_tpu

#: Subpackages of ``cqs_tpu`` whose ``__init__`` imports JAX.
JAX_PACKAGES = ("search", "models", "index", "cli")


class LazyInitPackage(types.ModuleType):
    """A package whose ``__init__`` runs on the first package-level
    attribute lookup that misses, not at import."""

    def __getattr__(self, name: str):
        if name.startswith("__") or self.__dict__.get("_lazy_init_done", True):
            raise AttributeError(f"module {self.__name__!r} has no attribute {name!r}")
        self.__dict__["_lazy_init_done"] = True
        init = self.__dict__["__file__"]
        exec(compile(Path(init).read_text(), init, "exec"), self.__dict__)
        try:
            return self.__dict__[name]
        except KeyError:
            raise AttributeError(
                f"module {self.__name__!r} has no attribute {name!r}") from None


def register_lazy_packages() -> None:
    """Register the lazy ``cqs_tpu.<pkg>`` modules not yet imported."""
    root = Path(cqs_tpu.__path__[0])
    for name in JAX_PACKAGES:
        full = f"cqs_tpu.{name}"
        if full in sys.modules:
            continue
        path = [str(root / name)]
        init = str(root / name / "__init__.py")
        spec = importlib.machinery.ModuleSpec(full, None, origin=init, is_package=True)
        spec.submodule_search_locations = path
        spec.has_location = True
        mod = LazyInitPackage(full)
        mod.__dict__.update(__path__=path, __package__=full, __spec__=spec,
                            __file__=init, _lazy_init_done=False)
        sys.modules[full] = mod
        setattr(cqs_tpu, name, mod)


register_lazy_packages()
