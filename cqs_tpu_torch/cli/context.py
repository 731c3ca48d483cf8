"""CLI command context: project root, config, store, models and engine on an
explicit device.

Port of ``cqs_tpu/cli/context.py``. Neural presets without local weights
fall back to the hash tier, as in the reference; with weights they raise
(not yet ported). Tiered serving (``tier_slot``) is not ported either.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch

from cqs_tpu.config import REGISTRY, Config, find_project_root
from cqs_tpu.models.registry import get_preset
from cqs_tpu.store import Store, resolve_slot, slot_dir
from cqs_tpu.utils.trace import get_tracer
from cqs_tpu_torch.device import resolve_device
from cqs_tpu_torch.models import Embedder, SpladeEncoder
from cqs_tpu_torch.search.engine import SearchEngine


@dataclass
class CommandContext:
    root: Path
    config: Config
    slot: str
    device: torch.device
    _store: Store | None = None
    _engine: SearchEngine | None = None
    _embedder: Embedder | None = None
    _splade: SpladeEncoder | None = None
    readonly: bool = False

    @classmethod
    def create(cls, path: str | None = None, slot: str | None = None,
               readonly: bool = False, *, device: str | torch.device) -> "CommandContext":
        root = find_project_root(path)
        config = Config.load(root)
        slot_name = resolve_slot(config.index_dir, slot)
        # a slot may carry its own config.toml whose model and scoring
        # sections win over the project's
        slot_cfg = slot_dir(config.index_dir, slot_name) / "config.toml"
        if slot_cfg.is_file():
            import tomllib

            with open(slot_cfg, "rb") as f:
                overlay = tomllib.load(f)
            emb = overlay.get("embedding", {})
            if emb.get("model"):
                config.model = str(emb["model"])
            if emb.get("model_path"):
                config.model_path = str(emb["model_path"])
            if "splade" in overlay and overlay["splade"].get("model_path"):
                config.splade_model_path = str(overlay["splade"]["model_path"])
            scoring = overlay.get("scoring", {})
            config.alpha_overrides.update(
                {str(k): float(v) for k, v in scoring.get("alpha", {}).items()})
            knobs = {k: v for k, v in scoring.items() if k != "alpha" and k in REGISTRY}
            if knobs:
                config.limits = config.limits.with_overrides(**knobs)
        return cls(root=root, config=config, slot=slot_name,
                   device=resolve_device(device), readonly=readonly)

    @property
    def index_dir(self) -> Path:
        return self.config.index_dir

    @property
    def slot_path(self) -> Path:
        return slot_dir(self.index_dir, self.slot)

    @property
    def store(self) -> Store:
        if self._store is None:
            self._store = Store.open(self.index_dir, slot=self.slot, readonly=self.readonly)
        return self._store

    @property
    def embedder(self) -> Embedder:
        if self._embedder is None:
            model, path = self.config.model, self.config.model_path
            # an existing index pins the model it was built with
            if model == "embeddinggemma-300m" and (self.slot_path / "index.db").exists():
                recorded = self.store.get_meta("embedder_model")
                if recorded:
                    model = recorded
            if get_preset(model).family != "hash" and path is None:
                get_tracer("cli").info(
                    "model %s has no local weights (set embedding.model_path); "
                    "using the 'hash' lexical embedder", model)
                model = "hash"
            self._embedder = Embedder(model, path, device=self.device)
        return self._embedder

    @property
    def splade(self) -> SpladeEncoder:
        if self._splade is None:
            model = self.config.splade_model
            if self.config.model in ("hash", "hash-tiny") and model == "splade-distil":
                model = "splade-hash"
            if self.config.splade_model_path is None and get_preset(model).family != "hash":
                model = "splade-hash"
            self._splade = SpladeEncoder(model, self.config.splade_model_path)
        return self._splade

    @property
    def engine(self) -> SearchEngine:
        if self._engine is None:
            if self.config.limits.tier_slot and self.config.limits.tier_slot != self.slot:
                raise NotImplementedError("tiered serving (tier_slot) is not yet ported")
            eng = SearchEngine(self.store, self.embedder, self._maybe_splade(),
                               slot_dir=self.slot_path, config=self.config,
                               device=self.device)
            eng.load_or_build_indexes()
            self._engine = eng
        return self._engine

    def _maybe_splade(self) -> SpladeEncoder | None:
        if self.config.limits.disable_splade:
            return None
        return self.splade

    def close(self) -> None:
        if self._engine is not None:
            self._engine.close()
        if self._store is not None:
            self._store.close()
