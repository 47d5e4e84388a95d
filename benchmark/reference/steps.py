"""The reference's adversarial training step and 30-sample evaluation,
replayed over the batches and random draws that the benchmark recorded.

A step's batch is given as its real bags (dataset index, row in the batch,
label) and the random draws of the step, in the order the step takes them:
the D phase (the generator in eval mode draws its head noise; D in train mode
scores the real pair, then the fake pair, each with four dropout draws),
then the G phase (the generator in train mode; D in eval mode draws
nothing). Losses are weighted means over the real bags; every bag enters
them on its own, so the reference runs one bag at a time and sums the
gradients. The ESAT generator is the one backbone replayed.
"""
from __future__ import annotations

import torch

from . import model as M

D_SITES = ["d.%s.%s" % (w, s) for w in ("real", "fake")
           for s in ("fc1", "pool.emb", "pool.scr", "fc2")]
G_SITES = ["g.attn", "g.out_proj", "g.ff1", "g.ff2", "g.pool.emb", "g.pool.scr",
           "g.head.drop", "g.head.noise"]
TRAIN_SITES = ["geval.noise"] + D_SITES + G_SITES
EVAL_SITES = ["noise1", "noiseK"]


def name_draws(draws: list, sites: list) -> dict:
    """The recorded draws [(kind, tensor)] of one step, by site; raises if
    their number or kinds do not fit."""
    if len(draws) != len(sites):
        raise ValueError(f"{len(draws)} random draws recorded, the step takes {len(sites)}")
    out = {}
    for (kind, t), s in zip(draws, sites):
        if kind == "randint":
            if s != "g.attn":
                raise ValueError(f"a flash seed where the step draws {s}")
            out[s] = ("philox", int(t.reshape(-1)[0]))
        else:
            out[s] = t
    return out


def bag_draws(named: dict, prefix: str, b: int, n: int) -> M.Draws:
    """The sites under `prefix` (e.g. "g.") cut to bag row b of n patches
    (its n / 16 regions)."""
    n_reg = n // M.S2
    sites = {}
    for k, t in named.items():
        if not k.startswith(prefix):
            continue
        name = k[len(prefix):]
        if t is None or isinstance(t, tuple):
            sites[name] = t
            continue
        u = t[b]
        if u.dim() == 3:
            u = u[:, :n_reg, :n_reg]
        elif u.dim() == 2:
            u = u[:n_reg]
        sites[name] = u
    return M.Draws(sites)


class Reference:
    """G and D parameters, their Adam states and the step's arithmetic."""

    def __init__(self, cfg: dict, params_g: dict, params_d: dict, device, mm=None):
        if cfg["bcb_mode"] != "patch":
            raise ValueError(f"the reference replays ESAT (bcb_mode patch), not {cfg['bcb_mode']!r}")
        self.cfg, self.mm = cfg, mm
        self.pg = {k: v.detach().to(device, torch.float32).clone() for k, v in params_g.items()}
        self.pd = {k: v.detach().to(device, torch.float32).clone() for k, v in params_d.items()}
        self.opt_g = M.Adam(self.pg, cfg["opt_netG_lr"], cfg["opt_netG_weight_decay"])
        self.opt_d = M.Adam(self.pd, cfg["opt_netD_lr"])
        self.rate_g = 0.25
        self.rate_head = float(cfg["gen_dropout"])
        self.rate_d = float(cfg["disc_netx_dropout"])

    # -- forward pieces ------------------------------------------------
    def gen(self, pg, x, d: M.Draws, b: int, noise, taps=None):
        H = M.esat_embed(pg, x, d, self.rate_g, b, self.mm, taps)
        return M.head(pg, H, noise, d["head.drop"], self.rate_head, self.mm)

    # -- one adversarial step ------------------------------------------
    def train_step(self, bags: list, draws: list, coef_gan: float, l1: float) -> dict:
        """bags: [(x [n, C], b, t, e)] the step's real bags; draws: the
        step's recorded draws. Returns the step's Loss_D, Loss_G_total, and
        by batch row the D phase's predictions and the G phase's predictions
        and encoder outputs [n / 16, D]."""
        named = name_draws(draws, TRAIN_SITES)
        n_real = len(bags)
        n_event = sum(1 for *_, e in bags if e == 1.0)
        gpreds, gencs = {}, {}
        # ---- D phase ----
        gd = {k: torch.zeros_like(v) for k, v in self.pd.items()}
        loss_d = 0.0
        preds = {}
        for x, b, t, e in bags:
            n = x.shape[0]
            with torch.no_grad():
                pred = self.gen(self.pg, x, M.Draws(), b, named["geval.noise"][b])
            preds[b] = float(pred[0])
            pd = {k: v.requires_grad_(True) for k, v in self.pd.items()}
            emb = M.disc_embed(pd, x, self.mm)
            real = M.disc(pd, emb, torch.tensor([t], device=x.device),
                          bag_draws(named, "d.real.", b, n), self.rate_d, self.mm)
            fake = M.disc(pd, emb, pred, bag_draws(named, "d.fake.", b, n),
                          self.rate_d, self.mm)
            lb = -(1.0 - torch.log(torch.sigmoid(fake) + 1e-8)) / n_real
            if e == 1.0:
                lb = lb - torch.log(torch.sigmoid(real) + 1e-8) / n_event
            grads = torch.autograd.grad(lb, list(pd.values()), allow_unused=True)
            for k, g in zip(pd, grads):
                if g is not None:
                    gd[k] += g
            loss_d += float(lb.detach())
            for v in self.pd.values():
                v.requires_grad_(False)
        self.opt_d.step(gd)
        # ---- G phase: D in eval mode, frozen ----
        gg = {k: torch.zeros_like(v) for k, v in self.pg.items()}
        loss_g = 0.0
        for x, b, t, e in bags:
            n = x.shape[0]
            pg = {k: v.requires_grad_(True) for k, v in self.pg.items()}
            d = bag_draws(named, "g.", b, n)
            taps = {}
            pred = self.gen(pg, x, d, b, named["g.head.noise"][b], taps)
            gpreds[b] = float(pred.detach()[0])
            gencs[b] = taps["encoder"].detach().cpu()
            with torch.no_grad():
                emb = M.disc_embed(self.pd, x, self.mm)
            f = M.disc(self.pd, emb, pred, M.Draws(), self.rate_d, self.mm)
            p = pred[0]
            recon = e * (p - t).abs() + (1.0 - e) * torch.relu(
                self.cfg["loss_recon_gamma"] - (p - t))
            lb = recon / n_real + coef_gan * (-f) / n_real
            grads = torch.autograd.grad(lb, list(pg.values()), allow_unused=True)
            for k, g in zip(pg, grads):
                if g is not None:
                    gg[k] += g
            loss_g += float(lb.detach())
            for v in self.pg.values():
                v.requires_grad_(False)
        if l1 > 1e-8:
            reg = 0.0
            for k, w in self.pg.items():
                reg += float(M.abs_plus(w).sum()) * l1
                gg[k] += l1 * torch.where(w >= 0, 1.0, -1.0)
            loss_g += reg
        self.opt_g.step(gg)
        return {"Loss_D": loss_d, "Loss_G_total": loss_g, "preds": preds, "gpreds": gpreds,
                "gencs": gencs}

    # -- the evaluation pass -------------------------------------------
    @torch.no_grad()
    def eval_bag(self, x, b: int, noise1, noise_k) -> dict:
        """One bag's y_hat, f_fake and lower median over the K samples."""
        H = M.esat_embed(self.pg, x, M.Draws(), self.rate_g, b, self.mm)
        y = M.head(self.pg, H, noise1, None, 0.0, self.mm)
        emb = M.disc_embed(self.pd, x, self.mm)
        f = M.disc(self.pd, emb, y, M.Draws(), 0.0, self.mm)
        K = noise_k.shape[0]
        dist = M.head(self.pg, H.expand(K, -1), noise_k, None, 0.0, self.mm)[:, 0]
        return {"y_hat": float(y[0]), "f_fake": float(f),
                "avg_y_hat": float(torch.median(dist).item())}

