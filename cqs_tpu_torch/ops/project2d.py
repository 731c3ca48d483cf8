"""2-D embedding projection for the cluster view.

Port of ``cqs_tpu/ops/project2d.py``: the default projector is an exact
top-2 PCA (an SVD of the centered rows with ``torch.linalg.svd`` on an
explicit device); umap-learn is used when it is importable, as in the
reference. The coordinates land in the chunk rows' ``umap_x``/``umap_y``,
which the serve UI renders.

A singular vector is defined up to its sign, and the reference's sign
already depends on its backend, so each axis of :func:`pca_2d` may come out
negated against the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from cqs_tpu_torch.device import resolve_device


def pca_2d(matrix: np.ndarray, *, device: str | torch.device) -> np.ndarray:
    """Exact top-2 PCA via SVD on ``device``. [N, D] -> [N, 2] f32."""
    x = torch.from_numpy(np.ascontiguousarray(matrix, dtype=np.float32)).to(
        resolve_device(device))
    x = x - x.mean(dim=0, keepdim=True)
    _, _, vt = torch.linalg.svd(x, full_matrices=False)
    return (x @ vt[:2].T).cpu().numpy()


def project_2d(matrix: np.ndarray, method: str = "auto", *,
               device: str | torch.device) -> np.ndarray:
    if method in ("auto", "umap"):
        try:
            import umap  # optional

            return umap.UMAP(n_components=2).fit_transform(matrix)
        except ImportError:
            if method == "umap":
                raise
    return pca_2d(matrix, device=device)


def store_projection(store, method: str = "auto", base: bool = False, *,
                     device: str | torch.device) -> int:
    """Compute and persist umap_x/umap_y for all embedded chunks."""
    ids, mat = store.load_embeddings(base=base)
    if not ids:
        return 0
    coords = project_2d(mat, method=method, device=device)
    with store.write_txn() as db:
        for cid, (x, y) in zip(ids, coords):
            db.execute("UPDATE chunks SET umap_x = ?, umap_y = ? WHERE id = ?",
                       (float(x), float(y), cid))
    return len(ids)
