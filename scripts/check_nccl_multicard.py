#!/usr/bin/env python3
"""The parallel path of `chip_smoke.py` phases 32-33 with one rank a card
(NCCL), on four cards:

    python3 scripts/check_nccl_multicard.py      # from the repo root, 4 cards

`chip_smoke.py` runs the ranks on one shared card over gloo; this runs them
as a node of H100s does. On the smoke data at cfg_nlst width (random
weights, seeded): one f32 adversarial ESAT step on the two long training
bags under dp 2 (cards 0, 1), dp 2 x inst 2 (cards 0-3) and inst 2 (cards
0, 1), and one ABMIL base step under dp 2 x inst 2, each against the
single-process step on card 0 (stepped gradients within 1e-4, parameters
within 1e-5 where Adam's first step is determined: `chip_smoke._check_params`);
then a bf16 2-epoch dp 4 training run and its test mode over dp 2 x inst 2
through `advmil_tpu_torch.main.run_one`, with equal metrics on every rank.
Prints each check and the collectives' time per step (device-synced host
clock, the second step in each process); fails on any miss.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402


def main():
    import torch
    from advmil_tpu_torch.config import with_defaults
    from advmil_tpu_torch.parallel import launch
    from advmil_tpu_torch.train.handler import AdvHandler
    from advmil_tpu_torch.train.baseline import BaselineHandler
    from advmil_tpu_torch.data.bags import prepare_dataset
    from advmil_tpu_torch.utils.io import read_datasplit_npz
    card = cs.timed("1 device", cs.phase_device)
    if torch.cuda.device_count() < 4:
        raise SystemExit(f"needs 4 cards, {torch.cuda.device_count()} visible")
    cs.timed("2 build", cs.phase_build)
    paths = cs.timed("4 data", cs.make_data)
    dev = torch.device("cuda", 0)

    def long_batch(h):
        tr, _, _ = read_datasplit_npz(h.cfg["data_split_path"].format(0))
        ds = prepare_dataset(tr, h.cfg)
        return list(h._make_bucket_batcher(ds).epoch_batches())[-1]

    cfg = with_defaults(cs._smoke_cfg(paths, "n4", test=False, epochs=1, es_warmup=0))
    h = AdvHandler(cfg)
    batch = long_batch(h)
    weights = cs._weights({"G": h.gen_model, "D": h.disc_model})
    start = {f"{t}.{n}": v.float() for t, sd in weights.items() for n, v in sd.items()}
    want = (start, cs._one_step("adv", cfg, weights, batch, dev))
    for devices, dp, inst in (([0, 1], 2, 1), ([0, 1, 2, 3], 2, 2), ([0, 1], 1, 2)):
        tag = f"nccl dp{dp} x inst{inst} ESAT step"
        res = launch.run_ranks(cs._rank_step, devices, ("adv", cfg, weights, batch, dp, inst))
        cs._ranks_summary(tag, res, card)
        cs._hold_step(tag, want, (res[0]["after"], res[0]["stepped"]), "adv", cfg,
                      tuple(batch.feats.shape))
        cs.log(f"[{tag}] launches rank 0 { {k: v for k, v in res[0]['launches'].items() if v} }")

    bcfg = with_defaults(cs._base_cfg(paths, "n4_base", test=False, epochs=1, es_warmup=0))
    bh = BaselineHandler(bcfg)
    bbatch = long_batch(bh)
    bw = cs._weights({"net": bh.model})
    bstart = {f"net.{n}": v.float() for n, v in bw["net"].items()}
    bwant = (bstart, cs._one_step("base", bcfg, bw, bbatch, dev))
    res = launch.run_ranks(cs._rank_step, [0, 1, 2, 3], ("base", bcfg, bw, bbatch, 2, 2))
    cs._ranks_summary("nccl dp2 x inst2 ABMIL step", res, card)
    cs._hold_step("nccl dp2 x inst2 ABMIL step", bwant, (res[0]["after"], res[0]["stepped"]),
                  "base", bcfg, tuple(bbatch.feats.shape))

    run_cfg = with_defaults(cs._smoke_cfg(paths, "run_n4", test=False, epochs=2, es_warmup=0,
                                          dp_devices=4))
    out = launch.run_ranks(cs._rank_run, [0, 1, 2, 3], ("adv", run_cfg))
    assert all(o["metrics"] == out[0]["metrics"] for o in out), "ranks' metrics differ"
    m = out[0]["metrics"]
    cs.log(f"[nccl dp4 exec] 2 epochs over 4 cards: metrics equal on all ranks, C-index "
           f"train {dict(m['train'])['cindex']:.4f} validation "
           f"{dict(m['validation'])['cindex']:.4f} test {dict(m['test'])['cindex']:.4f}; "
           f"rank 0 training bags/s {[round(b / s, 2) for b, s in out[0]['train_timings']]} "
           f"| launches rank 0 { {k: v for k, v in out[0]['launches'].items() if v} } | {card}")
    test_cfg = with_defaults(dict(run_cfg, test=True, dp_devices=2, inst_devices=2,
                                  test_save_path=os.path.join(cs.WORK_DIR, "n4_test_{}-{}")))
    out = launch.run_ranks(cs._rank_run, [0, 1, 2, 3], ("adv", test_cfg))
    assert all(o["metrics"] == out[0]["metrics"] for o in out), "ranks' test metrics differ"
    cs.log(f"[nccl 2x2 test] C-index {dict(out[0]['metrics']['exec-test'])['cindex']:.6f}, "
           f"equal on all ranks | launches rank 0 "
           f"{ {k: v for k, v in out[0]['launches'].items() if v} } | {card}")
    print("NCCL4_DONE")


if __name__ == "__main__":
    main()
