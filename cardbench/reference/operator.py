"""K·u of a whole model, element by element, in float64 plain PyTorch.

The reference's per-rank compute (gather, sign, Ke @ (ck * u), sign,
scatter-add; the reference solver's pcg_solver.py:277-300) over the global
model, without partitions: the same math as the port's float64 reference
``solver/numpy_ref.py``, written anew on torch tensors so that it runs on
the card once the program's state is freed.  Elements are applied in
blocks of at most ``block_elems`` so that the gathered rows fit.
"""

from __future__ import annotations

import numpy as np
import torch


def _rows(flat: np.ndarray, offset: np.ndarray, elems: np.ndarray,
          d: int) -> np.ndarray:
    """(len(elems), d) rows of a CSR-style per-element array whose rows
    have d entries."""
    idx = offset[elems][:, None] + np.arange(d)[None, :]
    return flat[idx]


class ElementOperator:
    """y = K·x for the model's elements and interface springs."""

    def __init__(self, model, device="cpu", block_elems: int = 1 << 20):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.n_dof = int(model.n_dof)
        self.block_elems = int(block_elems)
        self.groups = []
        for t in sorted(model.elem_lib):
            elems = np.flatnonzero(np.asarray(model.elem_type) == t)
            if not len(elems):
                continue
            Ke = np.asarray(model.elem_lib[t]["Ke"], dtype=np.float64)
            d = Ke.shape[0]
            dofs = _rows(model.elem_dofs_flat, model.elem_dofs_offset,
                         elems, d)
            signs = _rows(model.elem_sign_flat, model.elem_dofs_offset,
                          elems, d).astype(bool)
            self.groups.append({
                "Ke": torch.as_tensor(Ke, device=self.device),
                "dofs": torch.as_tensor(dofs.astype(np.int64),
                                        device=self.device),
                "signs": (torch.as_tensor(signs, device=self.device)
                          if signs.any() else None),
                "ck": torch.as_tensor(
                    np.asarray(model.ck, dtype=np.float64)[elems],
                    device=self.device),
            })
        sa, sb, sk, _ = model.interface_springs()
        self.springs = (torch.as_tensor(sa, device=self.device),
                        torch.as_tensor(sb, device=self.device),
                        torch.as_tensor(np.asarray(sk, np.float64),
                                        device=self.device))

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float64, device=self.device)
        y = torch.zeros(self.n_dof, dtype=torch.float64, device=self.device)
        for g in self.groups:
            n = g["dofs"].shape[0]
            for a in range(0, n, self.block_elems):
                dofs = g["dofs"][a:a + self.block_elems]
                u = x[dofs]
                signs = (g["signs"][a:a + self.block_elems]
                         if g["signs"] is not None else None)
                if signs is not None:
                    u = torch.where(signs, -u, u)
                v = (g["ck"][a:a + self.block_elems, None] * u) @ g["Ke"].T
                if signs is not None:
                    v = torch.where(signs, -v, v)
                y.index_add_(0, dofs.reshape(-1), v.reshape(-1))
        sa, sb, sk = self.springs
        if len(sa):
            f = sk * (x[sa] - x[sb])
            y.index_add_(0, sa, f)
            y.index_add_(0, sb, -f)
        return y
