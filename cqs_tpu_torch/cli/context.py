"""CLI command context: project root, config, store, models and engine on an
explicit device.

Port of ``cqs_tpu/cli/context.py``. A neural preset with a configured
``model_path`` runs its model on the context's device; without local
weights the embedder and the SPLADE encoder fall back to the hash tier, as
in the reference. With ``tier_slot`` set, ``engine`` is a
``TieredServing`` over this slot's engine and the tier slot's.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch

from cqs_tpu_torch.config import REGISTRY, Config, find_project_root
from cqs_tpu_torch.models.registry import get_preset
from cqs_tpu_torch.store import Store, resolve_slot, slot_dir
from cqs_tpu_torch.utils.trace import get_tracer
from cqs_tpu_torch.device import resolve_device
from cqs_tpu_torch.models import Embedder, SpladeEncoder
from cqs_tpu_torch.search.engine import SearchEngine, TieredServing


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
            rr = overlay.get("reranker", {})
            if rr.get("model"):
                config.reranker_model = str(rr["model"])
            if rr.get("model_path"):
                config.reranker_model_path = str(rr["model_path"])
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
            self._splade = SpladeEncoder(model, self.config.splade_model_path,
                                         device=self.device)
        return self._splade

    @property
    def engine(self) -> SearchEngine:
        if self._engine is None:
            eng = SearchEngine(self.store, self.embedder, self._maybe_splade(),
                               slot_dir=self.slot_path, config=self.config,
                               device=self.device)
            eng.load_or_build_indexes()
            self._engine = self._maybe_tiered(eng)
        return self._engine

    def _maybe_tiered(self, eng: SearchEngine):
        """Adaptive dual-TIER routing (knobs ``tier_slot``,
        ``tier_categories``): wrap the default engine so the listed
        categories are served by the other slot's engine, built by a full
        side-by-side context on the same device. A tier slot that cannot
        be opened leaves single-tier serving, with a warning, as in the
        reference."""
        tier_slot = self.config.limits.tier_slot
        if not tier_slot or tier_slot == self.slot:
            return eng
        cats = {c.strip() for c in self.config.limits.tier_categories.split(",") if c.strip()}
        if not cats:
            return eng
        try:
            self._tier_ctx = CommandContext.create(str(self.root), tier_slot,
                                                   readonly=self.readonly, device=self.device)
            tier_eng = self._tier_ctx.engine
        except Exception as e:
            get_tracer("context").warning(
                "tier_slot %r unavailable (%s); serving single-tier", tier_slot, e)
            return eng
        return TieredServing(eng, tier_eng, cats)

    def _maybe_splade(self) -> SpladeEncoder | None:
        if self.config.limits.disable_splade:
            return None
        return self.splade

    def close(self) -> None:
        tier = getattr(self, "_tier_ctx", None)
        if tier is not None:
            tier.close()
        if self._engine is not None:
            self._engine.close()
        if self._store is not None:
            self._store.close()
