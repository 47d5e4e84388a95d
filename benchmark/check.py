"""The comparison that decides `correct`.

Training cells: the reference (`reference/`) replays the recorded steps
(at least three, and on until one took the flash branch) from the
benchmark's own weights over the same bags and random draws. The candidate
numbers, of which `limits/<cell>.json` names those compared:

- `pred_gap` / `pred_median_gap`: each step's D-phase predictions (G in
  eval mode with the step's noise, on the parameters the earlier steps
  left), the largest and the median bag's |program - reference| over the
  real bags (the values lie in [0, 1]);
- `gpred_flash_gap`: the G-phase predictions (G in train mode, every
  dropout mask replayed, the flash keep masks from their Philox seeds) of
  the real bags of the first recorded step that took the flash branch, the
  worst bag's |program - reference|;
- `genc_flash_gap`: the same bags' ESAT encoder outputs (the attention
  layer's output after its feed-forward and norms, over the bag's real
  regions), the worst bag's ||program - reference|| / ||reference||. Both
  read the first flash step alone: later steps add the drift of Adam's
  sign-like first updates where a gradient element is nought to rounding;
- `loss_gap`: each step's Loss_D and Loss_G_total, |program - reference| over
  |reference| (`loss_d_gap`: Loss_D alone);
- `grad_gap`: the first gradient as each optimizer got it (the program's from
  Adam's first moment after step 1, m / (1 - beta1)), per leaf
  | ||g_prog|| - ||g_ref|| | over the larger of ||g_ref|| and the median
  leaf's norm, the worst leaf's;
- `change_gap`: the parameters' change over the recorded steps, per leaf,
  by the same measure, over the elements whose reference gradient is at
  least a thousandth of the median leaf's root-mean-square element (the
  others move under Adam by round-off alone);
- `grad_median_gap`, `change_median_gap`: the median leaf's gap of the two,
  steady from seed to seed (the worst leaf swings with the cancellation
  inside D's t tower).

Without a flash step the flash numbers are infinite, so a cell that names
them fails where no recorded step reached the gate.

Evaluation cells: every bag of the recorded pass, `pred_gap` the largest
|program - reference| of y_hat and the 30-sample lower median (both in
[0, 1]), `score_gap` the largest |f_fake| gap over the larger of |reference|
and the median |reference|; a bag with no answer fails.

`observe_*` turn a replay into those observables, so the control (the
reference in fp8 put in the program's place) is compared by the same code.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import steps as R

BETA1 = 0.9


def _bag_inputs(rec, cohort, device, b):
    i = int(rec["idx"][b])
    x = torch.from_numpy(cohort.feats[i]).to(device)
    return x, b, float(cohort.t[i]), float(cohort.e[i])


def replay_train(records, cohort, cfg, params0, device, mm=None) -> dict:
    """The reference's observables over the recorded steps."""
    ref = R.Reference(cfg, params0[0], params0[1], device, mm)
    losses, first = [], None
    for s, rec in enumerate(records):
        bags = [_bag_inputs(rec, cohort, device, b) for b in np.nonzero(rec["keep"])[0]]
        out = ref.train_step(bags, [(k, t.to(device)) for k, t in rec["draws"]],
                             float(cfg["loss_gan_coef"]), float(cfg["loss_regl1_coef"] or 0.0))
        out["flash"] = bool(rec["flash"])
        losses.append(out)
        if s == 0:
            first = ({k: v.cpu() for k, v in ref.opt_g.first_grad.items()},
                     {k: v.cpu() for k, v in ref.opt_d.first_grad.items()})
    after = ({k: v.cpu() for k, v in ref.pg.items()}, {k: v.cpu() for k, v in ref.pd.items()})
    return {"losses": losses, "first_grad": first, "params_after": after}


def observe_program(probe) -> dict:
    def step(r):
        real = [int(b) for b in np.nonzero(r["keep"])[0]]
        encs = {}
        if r["g_enc"] is not None:
            encs = {b: r["g_enc"][b, :int(r["sizes"][b]) // 16] for b in real}
        return dict(r["metrics"], flash=bool(r["flash"]),
                    preds={b: float(r["y_hat"][b]) for b in real},
                    gpreds={b: float(r["g_pred"][b]) for b in real}, gencs=encs)

    return {"losses": [step(r) for r in probe.records],
            "first_grad": tuple({k: v / (1.0 - BETA1) for k, v in fm.items()}
                                for fm in probe.first_moments),
            "params_after": probe.params_after}


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _leaf_rows(got: dict, want: dict) -> list:
    """(gap, leaf, ||got||, ||want||) per leaf: the gap of the two norms over
    the larger of ||want|| and the median leaf's."""
    ng, nw = _norms(got), _norms(want)
    med = float(np.median(list(nw.values())))
    return sorted(((abs(ng.get(k, float("inf")) - w) / max(w, med, 1e-30), k, ng.get(k), w)
                   for k, w in nw.items()), reverse=True)


def _moved(first_grad: dict) -> dict:
    """Per leaf, the elements whose reference gradient is at least a
    thousandth of the median leaf's root-mean-square element: the others
    (a key's bias under softmax, an attention score's bias) are nought to
    rounding and move under Adam by round-off alone."""
    rms = {k: float(torch.linalg.vector_norm(v.double())) / max(v.numel(), 1) ** 0.5
           for k, v in first_grad.items()}
    floor = 1e-3 * float(np.median(list(rms.values())))
    return {k: v.abs() >= floor for k, v in first_grad.items()}


def change_rows(got: dict, want: dict, params0) -> list:
    rows = []
    for net in range(2):
        moved = _moved(want["first_grad"][net])
        keep = {k for k, m in moved.items() if bool(m.any())}
        d_got = {k: (got["params_after"][net][k] - params0[net][k]) * moved[k] for k in keep}
        d_want = {k: (want["params_after"][net][k] - params0[net][k]) * moved[k] for k in keep}
        rows += _leaf_rows(d_got, d_want)
    return sorted(rows, reverse=True)


def grad_rows(got: dict, want: dict) -> list:
    return sorted((r for g, w in zip(got["first_grad"], want["first_grad"])
                   for r in _leaf_rows(g, w)), reverse=True)


def _rel(got, want) -> float:
    """||got - want|| / ||want||; infinite where the program gave nothing."""
    if got is None or got.shape != want.shape:
        return float("inf")
    d = torch.linalg.vector_norm((got.double() - want.double()).reshape(-1))
    return float(d / torch.linalg.vector_norm(want.double().reshape(-1)).clamp(min=1e-30))


def compare_train(got: dict, want: dict, params0) -> dict:
    """Every candidate number; `limits/<cell>.json` names those compared."""
    loss = loss_d = 0.0
    for g, w in zip(got["losses"], want["losses"]):
        for k in ("Loss_D", "Loss_G_total"):
            gap = abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
            loss = max(loss, gap)
            loss_d = max(loss_d, gap) if k == "Loss_D" else loss_d
    if len(got["losses"]) != len(want["losses"]):
        loss = loss_d = float("inf")
    preds = [abs(g["preds"].get(b, float("inf")) - v) for g, w in
             zip(got["losses"], want["losses"]) for b, v in w["preds"].items()]
    if not preds:
        preds = [float("inf")]
    flash = [(g, w) for g, w in zip(got["losses"], want["losses"]) if w["flash"]][:1]
    gpred = [abs(g["gpreds"].get(b, float("inf")) - v) for g, w in flash
             for b, v in w["gpreds"].items()] or [float("inf")]
    genc = [_rel(g["gencs"].get(b), v) for g, w in flash
            for b, v in w["gencs"].items()] or [float("inf")]
    grad = [r[0] for r in grad_rows(got, want)]
    change = [r[0] for r in change_rows(got, want, params0)]
    return {"pred_gap": max(preds), "pred_median_gap": float(np.median(preds)),
            "gpred_flash_gap": max(gpred), "genc_flash_gap": max(genc),
            "loss_gap": loss, "loss_d_gap": loss_d,
            "grad_gap": grad[0], "grad_median_gap": float(np.median(grad)),
            "change_gap": change[0], "change_median_gap": float(np.median(change))}


def replay_eval(records, cohort, cfg, params, device, mm=None) -> dict:
    """The reference's answers for every real bag of the recorded pass:
    dataset index -> {y_hat, f_fake, avg_y_hat}."""
    ref = R.Reference(cfg, params[0], params[1], device, mm)
    out = {}
    for rec in records:
        named = dict(zip(R.EVAL_SITES, [t for _, t in rec["draws"]]))
        if len(rec["draws"]) != len(R.EVAL_SITES):
            raise ValueError(f"{len(rec['draws'])} draws in an eval step, expected 2")
        n1, nk = named["noise1"].to(device), named["noiseK"].to(device)
        for b in np.nonzero(rec["keep"])[0]:
            x, b, _, _ = _bag_inputs(rec, cohort, device, b)
            out[int(rec["idx"][b])] = ref.eval_bag(x, b, n1[b], nk[:, b])
    return out


def observe_program_eval(probe) -> dict:
    out = {}
    for rec in probe.records:
        o = rec["out"]
        for b in np.nonzero(rec["keep"])[0]:
            out[int(rec["idx"][b])] = {"y_hat": float(o["y_hat"][b].reshape(-1)[0]),
                                       "f_fake": float(o["f_fake"][b]),
                                       "avg_y_hat": float(o["avg_y_hat"][b].reshape(-1)[0])}
    return out


def compare_eval(got: dict, want: dict, n_bags: int) -> dict:
    """Every candidate number; `limits/<cell>.json` names those compared."""
    keys = ("pred_gap", "pred_median_gap", "score_gap", "score_median_gap")
    if len(want) != n_bags or set(got) != set(want):
        return dict.fromkeys(keys, float("inf"))
    med = float(np.median([abs(w["f_fake"]) for w in want.values()]))
    pred = [max(abs(got[i][k] - w[k]) for k in ("y_hat", "avg_y_hat"))
            for i, w in want.items()]
    score = [abs(got[i]["f_fake"] - w["f_fake"]) / max(abs(w["f_fake"]), med, 1e-12)
             for i, w in want.items()]
    return dict(zip(keys, (max(pred), float(np.median(pred)), max(score),
                           float(np.median(score)))))


def judge(numbers: dict, limits: dict) -> bool:
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k] for k in limits)
