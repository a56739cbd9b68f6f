"""What the drivers share: the program's model built from the benchmark's
weights, the item table on the device, and the comparison of a training
cell's first steps with the reference's.

A training cell's set-up drives the program from the seed through its
first ``checked_updates`` optimizer updates, through the window's own call
and feed, and records each update's loss (the mean of its micro-steps'),
each parameter's first gradient as the optimizer got it (AdamW's first
moment after one update over ``1 - beta1``) and each parameter's change
after the last checked update. After the window the reference follows the
same updates from the same seed and inputs. Each number compared is a gap
of the program's reading from the reference's, by the worst leaf:
``|a - r| / max(r, median r)``; leaves whose reference gradient is under a
thousandth of the median leaf's (nought to rounding, such as a key's bias
under softmax) are left out of the change, which round-off alone moves.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..reference import batches as rb
from ..reference import model as rm
from ..weights import make_weights

ROUNDING_LEAF = 1e-3

# (phase, host clock at its end) of the run's set-up, in order
SETUP_MARKS: List[tuple] = []


def mark(phase: str) -> None:
    """Notes the end of a set-up phase, the device's work in it done."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    SETUP_MARKS.append((phase, time.perf_counter()))


def build_model(cls, cfg, weights: Dict[str, torch.Tensor], device):
    with torch.device(device):
        model = cls(cfg)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def table_to_device(table: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in table.items()}


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm([tensors[n].float() for n in names])).cpu()
    return {n: float(v) for n, v in zip(names, norms)}


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float], leaves) -> np.ndarray:
    med = float(np.median([ref[n] for n in leaves]))
    return np.array([abs(got[n] - ref[n]) / max(ref[n], med) for n in leaves])


def train_readings(got: dict, ref: dict) -> Dict[str, float]:
    """Gaps of ``got`` from ``ref``; each a dict with ``loss`` (per update),
    ``grad`` and ``change`` (leaf norms by name). The ``*_gap`` of the
    gradient and the change are the worst leaf's, ``*_median_gap`` the
    median leaf's (a cell's limits name the numbers it compares)."""
    loss = max(abs(a - r) / abs(r) for a, r in zip(got["loss"], ref["loss"]))
    g = ref["grad"]
    med = float(np.median(list(g.values())))
    moved = [n for n in g if g[n] >= ROUNDING_LEAF * med]
    grad = leaf_gaps(got["grad"], g, list(g))
    change = leaf_gaps(got["change"], ref["change"], moved)
    return {"loss_gap": loss, "grad_gap": float(grad.max()), "change_gap": float(change.max()),
            "grad_median_gap": float(np.median(grad)),
            "change_median_gap": float(np.median(change))}


class TrainRecord:
    """The program's first ``updates`` optimizer updates, as the set-up
    drives them."""

    def __init__(self, model, optimizer, cfg, head: str, weight_seed: int, device):
        self.model, self.optimizer = model, optimizer
        self.cfg, self.head, self.weight_seed, self.device = cfg, head, weight_seed, device
        self._losses: List[torch.Tensor] = []
        self.grad: Dict[str, torch.Tensor] | None = None

    def after_micro_step(self, loss: torch.Tensor, updated: bool):
        self._losses.append(loss)
        if updated and self.grad is None:
            opt = self.optimizer
            b1 = opt.optimizer.param_groups[0]["betas"][0]
            names = [n for n, p in self.model.named_parameters() if p.requires_grad]
            # a parameter without state took no update: its gradient reads 0
            self.grad = {n: opt.optimizer.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
                         / (1.0 - b1) for n, p in zip(names, opt.params)}

    def finish(self, accum: int) -> dict:
        w0 = make_weights(self.cfg, self.head, self.weight_seed, self.device)
        params = dict(self.model.named_parameters())
        change = leaf_norms({n: params[n].detach() - w0[n] for n in w0})
        del w0
        losses = torch.stack(self._losses).double().view(-1, accum).mean(1).cpu().tolist()
        grad = (leaf_norms(self.grad) if self.grad is not None
                else {n: 0.0 for n, p in params.items() if p.requires_grad})
        rec = {"loss": losses, "grad": grad, "change": change}
        self.grad = None
        return rec


class TrainChecks:
    """A training driver's comparisons: its ``program_record`` against its
    ``reference_record()``, which the driver provides."""

    _ref = None

    def _reference(self) -> dict:
        if self._ref is None:
            self._ref = self.reference_record()
        return self._ref

    def check(self) -> dict:
        return train_readings(self.program_record, self._reference())

    def control(self) -> dict:
        """The reference computed in fp8, in the program's place."""
        return train_readings(self.reference_record("fp8"), self._reference())

    def fault(self, name: str) -> dict:
        """The reference with a fault planted (``half_batch``: the loss
        over half the batch), in the program's place."""
        return train_readings(self.reference_record("fp32", name), self._reference())


def reference_record(opt, losses: List[float], accum: int, w0: Dict[str, torch.Tensor]) -> dict:
    """The reference's readings after its updates (:class:`reference.optim.AdamW`)."""
    per_update = np.asarray(losses, np.float64).reshape(-1, accum).mean(1).tolist()
    with torch.no_grad():
        change = leaf_norms({n: opt.p[n] - w0[n] for n in w0})
    return {"loss": per_update, "grad": leaf_norms(opt.first_grad), "change": change}


@torch.no_grad()
def reference_pooled(P, cfg, table_np, item_ids: np.ndarray, seq_lens: np.ndarray, out_len: int,
                     num, device, chunk: int = 256) -> torch.Tensor:
    """The reference's pooled (n, hs) float32 outputs of rows of item ids,
    ``chunk`` rows at a time."""
    out = []
    for s in range(0, len(item_ids), chunk):
        batch = rb.assemble(table_np, item_ids[s:s + chunk], seq_lens[s:s + chunk], out_len, cfg,
                            device)
        out.append(rm.encode(P, cfg, batch, batch["input_ids"], None, num)[:, 0])
    return torch.cat(out)
