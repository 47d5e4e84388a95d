"""Flat YAML config loading and the checks that apply to the ported slice.

The repo's configs are flat `key: value` files (config/*.yaml). They are read
here with the standard library: scalars, `[a, b]` flow lists, `- item` block
lists, comments and null, resolved the way PyYAML's default loader resolves
them (so `1e-5` without a dot stays a string, `yes`/`on` are booleans).

The port runs the adversarial handler (`--handler adv`: cont_gansurv and
disc_gansurv, supervised and semi-supervised) and the baseline handler
(`--handler base`), each in training (`exec`, `test: False`) and test mode
(`test: True`), on the four backbones, with every optimizer of the JAX
factory (AdaHessian under `--handler base`) and gradient accumulation, in
one process or over several (`dp_devices`, `dist_*`, `inst_devices`), with
`log_plot`. The one mode it lacks (AdaHessian through the kernels on the
card) is rejected by `check_configs` with an error naming its ROADMAP item.
"""
from __future__ import annotations

import itertools
import re

from .utils.func import sparse_str

PORT_DEFAULTS = {
    "device": "cuda",              # cuda | cpu; never chosen implicitly
    "batch_token_budget": 32768,   # patches per batch (bucketed padding)
    "batch_max_size": 64,          # max bags per batch
    "bucket_min": 256,             # smallest bag bucket (multiple of 16)
    "bucket_growth": 2.0,          # geometric growth between bucket sizes
    "precision": "f32",            # f32 | bf16 compute, f32 parameters
    "use_pallas": True,            # hand-written attention kernel on long bags
    "flash_min_len": 512,          # eval floors the gate at max(this, 2048)
    "use_fused_lnpool": True,      # hand-written LN+ReLU+region-mean kernel
    # hand-written Dense+LN+ReLU+region-mean kernels in G's patch embedding; off
    # (the JAX package's default) until a bench cell decides
    "use_fused_embedding": False,
    "use_coords_pe": False,        # feed region coords (path_coordx5) to ESAT
    "tra_backbone": "Transformer",  # Transformer | Identity (no encoder)
    # PatchGCN (bcb_mode: graph), the JAX package's defaults
    "num_graph_layers": 1,
    "graph_edge_agg": "spatial",   # spatial | latent: which npz edge set
    "graph_edges_per_node": 9,     # dense edge slots per node (in-degree cap)
    "graph_banded": "auto",        # auto: banded or grid route when coverage >= 0.7 | off
    # the grid route engages only while the slides' grids hold at most this
    # many cells per patch
    "graph_grid_max_inflation": 3.0,
    # grid route: keep the whole GCN stack on the grid rows (place once)
    "graph_grid_resident": False,
    "cache_bags": True,
    "num_workers": 0,              # > 1: thread-pool batch assembly
    "save_prediction": True,
    "gen_updates": 1,
    "accum_steps": 1,              # > 1: optax.MultiSteps' accumulation
    "accum_drop_remainder": False,  # drop a partial accumulator at epoch end
    "loss_regl1_coef": 0.0,
    "train_sampling": None,        # count or fraction of the training patients
    "test": False,
    "semi_training": False,
    "semi_training_mode": "none",  # UD+LD | LD | UD | none
    "wandb_prj": None,
}

# ---------------------------------------------------------------------------
# YAML subset reader
# ---------------------------------------------------------------------------

_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
# PyYAML's YAML 1.1 implicit resolvers (resolver.py) for int and float
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that starts a line or follows whitespace, outside
    quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(tok: str):
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        t = tok.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if t != "0" and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(tok):
        t = tok.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    return tok


def _value(tok: str):
    tok = tok.strip()
    if tok.startswith("[") and tok.endswith("]"):
        inner = tok[1:-1].strip()
        return [_scalar(p) for p in inner.split(",")] if inner else []
    return _scalar(tok)


def read_yaml(path: str) -> dict:
    """Parse a flat YAML mapping (the repo's config format) into a dict."""
    out: dict = {}
    bare = set()        # `key:` lines: null unless a block list follows
    key = None
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = _strip_comment(raw.rstrip("\n")).rstrip()
            if not line.strip():
                continue
            stripped = line.lstrip()
            if stripped.startswith("- "):
                if key is None or not isinstance(out[key], list):
                    raise ValueError(f"{path}:{lineno}: list item outside a "
                                     "block list")
                out[key].append(_scalar(stripped[2:]))
                bare.discard(key)
                continue
            if line[0] in " \t" or ":" not in line:
                raise ValueError(f"{path}:{lineno}: not a flat `key: value` "
                                 f"line: {raw.rstrip()}")
            k, v = line.split(":", 1)
            key = k.strip()
            if v.strip() == "":
                out[key] = []
                bare.add(key)
            else:
                out[key] = _value(v)
    for k in bare:
        out[k] = None
    return out


def get_config(config_path: str) -> dict:
    return with_defaults(read_yaml(config_path))


def with_defaults(cfg: dict) -> dict:
    out = dict(PORT_DEFAULTS)
    out.update(cfg)
    return out


def grid(kwargs: dict) -> list:
    """Expand every list-valued key into a full cartesian grid."""
    listed = {k: v for k, v in kwargs.items() if isinstance(v, list)}
    fixed = {k: v for k, v in kwargs.items() if not isinstance(v, list)}
    if not listed:
        return [dict(kwargs)]
    keys = list(listed.keys())
    out = []
    for combo in itertools.product(*[listed[k] for k in keys]):
        cfg = dict(fixed)
        cfg.update(dict(zip(keys, combo)))
        out.append(cfg)
    return out


def grid_hyperparams(kwargs: dict) -> list:
    return [k for k, v in kwargs.items() if isinstance(v, list)]


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

BASE_TASKS = ("surv_cox", "surv_nll", "surv_reg")


def _not_ported(cfg: dict, handler: str) -> list:
    """(key, value, reason) for every requested mode the port refuses:
    AdaHessian through the patch or graph backbone's kernels on the card,
    whose backwards refuse the double backward (`ops/_build.py::
    first_order`), as the JAX package's Pallas kernels have none
    (`tests/test_torch_second_order.py`)."""
    if (handler == "base" and cfg.get("device") == "cuda"
            and cfg.get("bcb_mode") in ("patch", "graph")
            and str(cfg.get("opt_net")).lower() == "adahessian"):
        return [("opt_net", cfg["opt_net"],
                 f"ROADMAP A19: AdaHessian's Hessian-vector product through the "
                 f"{cfg['bcb_mode']} backbone's kernels on the card; the JAX package has no "
                 "second derivative through its kernels either; device: cpu runs it")]
    return []


def check_configs(cfg: dict, handler: str = "adv"):
    """Cross-field validation (the checks of `advmil_tpu.config.check_configs`
    that apply to the ported slices), then the port's own limits. The
    refusals, the device, precision, patch and graph checks apply to both
    handlers; the generator / discriminator checks to `adv` only (the JAX
    baseline handler asserts its task and nothing else).

    Like the JAX package's, it writes `ssl_es_warmup` into `cfg`: the
    semi-supervised run's early stopping waits `ssl_kfold` epochs under
    UD+LD (one pass over every fold loader) and none otherwise, whatever
    the YAML says."""
    if handler not in ("adv", "base"):
        raise ValueError(f"unknown handler {handler!r} (adv | base)")
    missing = _not_ported(cfg, handler)
    if missing:
        raise NotImplementedError("; ".join(
            f"{k}: {v} is refused ({reason})" for k, v, reason in missing))
    for key in ("dp_devices", "inst_devices"):
        if cfg.get(key) is not None and int(cfg[key]) < 1:
            raise ValueError(f"{key} must be a positive rank count, got {cfg[key]!r}")
    if cfg.get("device") not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {cfg.get('device')!r}")
    if cfg.get("precision") not in ("f32", "bf16", "bfloat16"):
        raise ValueError(f"precision must be f32 or bf16, got {cfg.get('precision')!r}")
    if cfg.get("use_coords_pe") and not cfg.get("path_coordx5"):
        raise ValueError("use_coords_pe needs path_coordx5 (per-slide region coordinates)")
    if cfg.get("bcb_mode") == "graph":
        assert cfg["graph_edge_agg"] in ("spatial", "latent"), \
            "graph_edge_agg must be spatial/latent"
        # YAML reads a bare `off` as False
        assert cfg["graph_banded"] in ("auto", "off", False), "graph_banded must be auto/off"
        assert 1 <= int(cfg["graph_edges_per_node"]) <= 16, \
            "graph_edges_per_node must be 1-16 (the aggregation kernels' slot limit)"
    assert cfg.get("monitor_metrics", "loss") in ("loss", "ci", "ci_max"), \
        "monitor_metrics must be loss / ci (reference-inverted) / ci_max"
    if handler == "base":
        if cfg["task"] not in BASE_TASKS:
            raise ValueError(f"task {cfg['task']} is not a baseline task "
                             f"({' / '.join(BASE_TASKS)}); use --handler adv")
        if cfg.get("semi_training"):
            raise ValueError("semi_training runs under --handler adv (the baseline "
                             "handler has no semi-supervised mode)")
        return
    if cfg.get("log_plot"):     # drawn by the adversarial handler only, as in JAX
        try:
            import matplotlib  # noqa: F401
        except ImportError as exc:
            raise ImportError("log_plot: True draws its histograms with matplotlib, "
                              "which cannot be imported here; set log_plot: False") from exc
    if cfg.get("disc_netx_backbone") not in (None, "avgpool", "gapool"):
        raise ValueError("disc_netx_backbone must be avgpool or gapool, got "
                         f"{cfg['disc_netx_backbone']!r}")
    if cfg.get("disc_netx_ksize") not in (None, 1, 3):
        raise ValueError(f"disc_netx_ksize must be 1 or 3, got {cfg['disc_netx_ksize']!r}")
    if cfg["task"] not in ("cont_gansurv", "disc_gansurv"):
        raise ValueError(f"task {cfg['task']} is not an adversarial task "
                         "(cont_gansurv / disc_gansurv); surv_cox / surv_nll / "
                         "surv_reg run under --handler base")
    assert cfg["loss_netD"] in ["bce", "hinge", "wasserstein"], \
        f"loss_netD must be bce/hinge/wasserstein, got {cfg['loss_netD']}"
    assert cfg["loss_recon_norm"] in ["l1", "l2"], "loss_recon_norm must be l1/l2"
    assert cfg["gen_noi_noise_dist"] in ["uniform", "gaussian"], \
        "gen_noi_noise_dist must be uniform/gaussian"
    assert cfg["gen_noi_hops"] + 1 == len(str(cfg["gen_noi_noise"]).split("-")), \
        "gen_noi_noise must have gen_noi_hops+1 dash-separated flags"
    assert cfg["disc_netx_in_dim"] == int(cfg["bcb_dims"].split("-")[0]), \
        "disc_netx_in_dim must equal the first entry of bcb_dims"
    assert cfg["disc_nety_in_dim"] == int(str(cfg["gen_dims"]).split("-")[-1]), \
        "disc_nety_in_dim must equal the last entry of gen_dims"
    assert cfg["disc_netx_out_dim"] == int(cfg["disc_nety_hid_dims"].split("-")[-1]), \
        "disc_netx_out_dim must equal the last entry of disc_nety_hid_dims"
    assert cfg.get("ssl_resume_ckpt", "best") in ["last", "best"]
    noise_existing = sum(sparse_str(cfg["gen_noi_noise"])) > 0
    if noise_existing:
        assert cfg["times_test_sample"] > 1
    else:
        assert cfg["times_test_sample"] == 1
    mode = cfg.get("semi_training_mode", "none") or "none"
    cfg["ssl_es_warmup"] = cfg["ssl_kfold"] if "UD" in mode and "LD" in mode else 0
    if cfg["task"] == "cont_gansurv":
        assert cfg["time_format"] in ["origin", "ratio"]
        assert str(cfg["gen_dims"])[-2:] == "-1"
        assert (cfg["gen_out_scale"] == "sigmoid" and cfg["time_format"] == "ratio") or \
               (cfg["gen_out_scale"] != "sigmoid" and cfg["time_format"] == "origin"), \
            "cont_gansurv needs sigmoid<->ratio or exp/none<->origin pairing"
        assert (cfg["time_format"] == "ratio" and cfg["loss_recon_gamma"] == 0) or \
               (cfg["time_format"] == "origin" and cfg["loss_recon_gamma"] >= 1), \
            "loss_recon_gamma must be 0 for ratio time, >=1 for origin time"
    else:   # disc_gansurv: G emits time_bins hazards over quantile bins
        assert cfg["time_format"] == "quantile", "disc_gansurv needs time_format: quantile"
        assert cfg["gen_out_scale"] == "sigmoid", "disc_gansurv needs gen_out_scale: sigmoid"
        assert cfg["disc_nety_in_dim"] == cfg["time_bins"], \
            "disc_gansurv needs disc_nety_in_dim == time_bins"
        assert cfg.get("log_plot", False) is False, "disc_gansurv draws no log_plot"
