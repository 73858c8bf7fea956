"""Roofline analysis: compute / memory / collective terms per (arch x shape),
over the H100 SXM (the counterpart of ``repro.launch.roofline``).

  python -m repro_torch.launch.roofline [--strategy NAME] [--json]
  python -m repro_torch.launch.roofline --compare qwen2.5-3b train_4k

  * FLOPs, HBM bytes and collective wire bytes come from the reference's
    ANALYTIC per-cell model, driven by the exact configs and a sharding
    strategy: ``cell_flops``, ``cell_bytes`` and ``cell_collectives`` keep
    the reference's formulas in its order of operations, so each gives
    the reference's numbers bit for bit. ``launch.dryrun`` counts the
    port's own step on the meta device beside them.

  * terms (seconds, per training/serving step, over ``CHIPS`` cards):
      compute    = FLOPs / (CHIPS * hw.PEAK_FLOPS_BF16)
      memory     = HBM bytes / (CHIPS * hw.HBM_BW)
      collective = wire bytes on the busiest link / hw.NVLINK_BW_PER_LINK
    with the H100 SXM's data-sheet rates from ``repro_torch.launch.hw``
    (989e12 dense bf16 FLOP/s, 3.35e12 HBM bytes/s, 50e9 NVLink bytes/s a
    link, each cited there), read when a roofline is built.

  * ``CHIPS`` stays the reference's 256, so the table's cells are the
    reference's. 256 H100s are 32 HGX nodes of 8; NVLink joins the cards
    of one node only, and the rest cross the slower network between
    nodes, so over 256 cards the collective term is a lower bound.

  * MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE); the ratio
    MODEL_FLOPS / total-FLOPs reports remat overhead + attention/non-matmul
    work (the remat policy recomputes each layer group once in bwd).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import hw
from repro_torch.models import get_model

CHIPS = 256  # the reference's table mesh, (16, 16)


@dataclasses.dataclass(frozen=True)
class Strategy:
    """The sharding knobs. ``baseline`` is the paper-faithful default
    strategy the dry-run table uses; the others are the reference's
    beyond-baseline variants."""
    name: str = "baseline"
    dp: int = 16            # data-parallel degree (dp * tp == 256)
    tp: int = 16            # tensor-parallel degree
    fsdp_params: bool = True     # shard params over dp (ZeRO-3 style)
    serve_fsdp: bool = True      # keep FSDP during serving steps too
    remat_factor: float = 1.0    # fwd recompute fraction in bwd
    act_allreduce_per_layer: int = 2  # row-parallel matmul reductions
    kv_bytes_scale: float = 1.0  # EXTENT int8 KV store -> 0.5


BASELINE = Strategy()

STRATEGIES = {
    "baseline": BASELINE,
    # wider DP, narrower TP: per-layer activation all-reduce shrinks ~dp/tp
    "dp64_tp4": Strategy(name="dp64_tp4", dp=64, tp=4),
    # prefill_32k has global_batch=32: dp must divide it
    "dp32_tp8": Strategy(name="dp32_tp8", dp=32, tp=8),
    "dp256_tp1": Strategy(name="dp256_tp1", dp=256, tp=1,
                          act_allreduce_per_layer=0),
    # serving: params sharded over TP only -> no per-token all-gather
    "serve_tp_only": Strategy(name="serve_tp_only", serve_fsdp=False),
    "serve_tp_only_dp64": Strategy(name="serve_tp_only_dp64", dp=64, tp=4,
                                   serve_fsdp=False),
    # selective remat: keep attention/mlp outs, recompute only cheap ops
    "selective_remat": Strategy(name="selective_remat", remat_factor=0.35),
    "dp64_tp4_selremat": Strategy(name="dp64_tp4_selremat", dp=64, tp=4,
                                  remat_factor=0.35),
    # EXTENT-native: KV stored int8 through the bit-priority quality map
    # (LOW-level writes carry 8-bit payloads) -> cache traffic halves
    "serve_tp_only_kvq8": Strategy(name="serve_tp_only_kvq8",
                                   serve_fsdp=False, kv_bytes_scale=0.5),
}


# ---------------------------------------------------------------------------
# analytic FLOPs
# ---------------------------------------------------------------------------

def _attn_context(cfg: ModelConfig, S: int) -> float:
    """Mean visible keys per query position, averaged over layers."""
    total = 0.0
    for w in cfg.layer_windows(S):
        if w >= S:
            total += (S + 1) / 2.0          # causal full
        else:
            # ramp-up for the first w positions then flat window
            total += (w * (w + 1) / 2.0 + (S - w) * w) / S
    return total / max(1, cfg.num_layers)


def _layer_matmul_flops(cfg: ModelConfig, T: float) -> float:
    """Per-token-weighted matmul flops of ALL layers (fwd), ex-attention."""
    D, H, K, h, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim, cfg.d_ff)
    L = cfg.num_layers
    if cfg.family == "ssm":
        d_inner = cfg.ssm_expand * D
        Hs = d_inner // cfg.ssm_headdim
        N = cfg.ssm_state
        per_tok = 2 * D * (2 * d_inner + 2 * N + Hs)   # in_proj
        per_tok += 2 * d_inner * D                     # out_proj
        # SSD: intra-chunk (Q-blocked) + state path
        Q = cfg.ssm_chunk
        per_tok += 2 * Q * N + 2 * Q * Hs + 2 * Q * d_inner  # G, M, y_intra
        per_tok += 4 * N * d_inner                      # state update + y_inter
        return L * T * per_tok
    if cfg.family == "hybrid":
        R = cfg.lru_width
        n_att = sum(1 for i in range(L)
                    if cfg.block_pattern[i % len(cfg.block_pattern)] == "A")
        n_rec = L - n_att
        rec = 2 * D * R * 2 + 2 * R * R * 2 + 2 * R * D
        att = 2 * D * (H + 2 * K) * h + 2 * H * h * D
        mlp = 3 * 2 * D * F  # every layer has an MLP block
        return T * (n_rec * rec + n_att * att + L * mlp)
    # transformer-family (dense/moe/vlm/audio decoder)
    qkv = 2 * D * (H + 2 * K) * h
    wo = 2 * H * h * D
    if cfg.num_experts:
        k = cfg.experts_per_token
        ffn = 2 * D * cfg.num_experts          # router
        ffn += 3 * 2 * k * cfg.capacity_factor * D * F  # dispatched experts
    else:
        ffn = 3 * 2 * D * F
    return L * T * (qkv + wo + ffn)


def _attention_flops(cfg: ModelConfig, T: float, ctx: float) -> float:
    """QK^T + PV flops over all layers. ctx = mean visible keys/query."""
    if cfg.family == "ssm":
        return 0.0
    H, h, L = cfg.num_heads, cfg.head_dim, cfg.num_layers
    if cfg.family == "hybrid":
        n_att = sum(1 for i in range(L)
                    if cfg.block_pattern[i % len(cfg.block_pattern)] == "A")
        return 4 * T * ctx * H * h * n_att
    return 4 * T * ctx * H * h * L


def _head_flops(cfg: ModelConfig, T: float) -> float:
    return 2 * T * cfg.d_model * cfg.vocab_size


def cell_flops(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    """Total-step FLOPs decomposition for one cell (all chips combined)."""
    B, S = shape.global_batch, shape.seq_len
    api = get_model(cfg)
    n_active = api.active_params_per_token()

    if shape.kind == "decode":
        T = float(B)  # one token per sequence
        # decode sees the *current* context length ~ S (not the causal ramp)
        ctx = 0.0
        for w in cfg.layer_windows(S):
            ctx += min(w, S)
        ctx /= max(1, cfg.num_layers)
        fwd = (_layer_matmul_flops(cfg, T) + _attention_flops(cfg, T, ctx)
               + _head_flops(cfg, T))
        if cfg.is_encoder_decoder:
            fwd += 4 * T * 1500 * cfg.num_heads * cfg.head_dim * cfg.num_layers
        return {"fwd": fwd, "bwd": 0.0, "remat": 0.0, "total": fwd,
                "model_flops": 2 * n_active * T,
                "tokens": T}

    T = float(B) * S
    ctx = _attn_context(cfg, S)
    fwd = (_layer_matmul_flops(cfg, T) + _attention_flops(cfg, T, ctx)
           + _head_flops(cfg, T))
    model_fwd = 2 * n_active * T
    if cfg.is_encoder_decoder:
        # batch_shapes: encoder runs on S frames; decoder on S/512 tokens.
        # 6ND is ill-posed for enc-dec: account each stack at its own T.
        dec = max(64, S // 512)
        T_dec = float(B) * dec
        fwd = (_layer_matmul_flops(cfg, T) + _attention_flops(cfg, T, ctx)
               + _layer_matmul_flops(cfg, T_dec)
               + 4 * T_dec * S * cfg.num_heads * cfg.head_dim * cfg.num_layers
               + _head_flops(cfg, T_dec))
        # encoder ~ half the params at T frames, decoder ~ half at T_dec
        model_fwd = 2 * (n_active / 2) * T + 2 * (n_active / 2) * T_dec
    if shape.kind == "prefill":
        return {"fwd": fwd, "bwd": 0.0, "remat": 0.0, "total": fwd,
                "model_flops": model_fwd, "tokens": T}
    bwd = 2.0 * fwd
    remat = 1.0 * fwd  # one forward recompute per layer group in bwd
    total = fwd + bwd + remat
    return {"fwd": fwd, "bwd": bwd, "remat": remat, "total": total,
            "model_flops": 3 * model_fwd, "tokens": T}


# ---------------------------------------------------------------------------
# analytic HBM bytes
# ---------------------------------------------------------------------------

def cell_bytes(cfg: ModelConfig, shape: ShapeConfig,
               strat: Strategy = BASELINE) -> Dict[str, float]:
    """Whole-step HBM traffic (all chips combined), bf16 params/activations,
    f32 optimizer moments."""
    api = get_model(cfg)
    P = api.num_params()
    P_active = api.active_params_per_token()
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model

    def kv_bytes_total() -> float:
        if cfg.family == "ssm":
            d_inner = cfg.ssm_expand * D
            Hs = d_inner // cfg.ssm_headdim
            st = cfg.num_layers * B * (Hs * cfg.ssm_headdim * cfg.ssm_state
                                       * 4 + (cfg.ssm_conv_width - 1)
                                       * (d_inner + 2 * cfg.ssm_state) * 4)
            return float(st)
        per_pos = 2 * cfg.num_kv_heads * cfg.head_dim * 2  # K+V bf16
        total = 0.0
        if cfg.family == "hybrid":
            L = cfg.num_layers
            n_att = sum(1 for i in range(L)
                        if cfg.block_pattern[i % 3] == "A")
            total += n_att * B * min(cfg.local_window, S) * per_pos
            total += (L - n_att) * B * cfg.lru_width * 4 * 2
            return total
        for w in cfg.layer_windows(S):
            total += B * min(w, S) * per_pos
        if cfg.is_encoder_decoder:
            total += cfg.num_layers * B * 1500 * per_pos
        return total

    if shape.kind == "decode":
        # weights once per step + full cache read + one-slot write
        kv = kv_bytes_total() * strat.kv_bytes_scale
        return {"params": 2.0 * P_active, "cache": kv,
                "activations": B * cfg.num_layers * D * 2 * 8.0,
                "opt": 0.0,
                "total": 2.0 * P_active + kv
                + B * cfg.num_layers * D * 2 * 8.0}

    T = float(B) * S
    act_per_layer = T * D * 2 * 10.0  # ~10 tensor r/w per layer through HBM
    acts = cfg.num_layers * act_per_layer
    if shape.kind == "prefill":
        total = 2.0 * P + acts + kv_bytes_total()
        return {"params": 2.0 * P, "cache": kv_bytes_total(),
                "activations": acts, "opt": 0.0, "total": total}
    # train: fwd read + bwd read + remat read (bf16) + opt update
    params = 3 * 2.0 * P          # three weight passes, bf16
    opt = (8 + 8 + 4 + 2 + 2) * float(P)  # m rw, v rw(f32) grad r, p rw(bf16)
    acts_train = acts * 2.5        # fwd + remat-recompute + bwd consumers
    total = params + opt + acts_train
    return {"params": params, "cache": 0.0, "activations": acts_train,
            "opt": opt, "total": total}


# ---------------------------------------------------------------------------
# analytic collective wire bytes (per busiest device, dp x tp mesh)
# ---------------------------------------------------------------------------

def cell_collectives(cfg: ModelConfig, shape: ShapeConfig,
                     strat: Strategy = BASELINE) -> Dict[str, float]:
    """Per-device wire bytes per step:
       params FSDP over data(dp) -> all-gather fwd + bwd, grads
       reduce-scatter over data; activations all-reduce over model(tp)
       after attention + mlp row-parallel matmuls."""
    api = get_model(cfg)
    P = api.num_params()
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    dp, tp = strat.dp, strat.tp
    g_tp = (tp - 1) / tp if tp > 1 else 0.0
    T_dev = float(B) * (S if shape.kind != "decode" else 1) / dp

    # per-device share of the parameter bytes (each device holds P/(dp*tp))
    p_shard = 2.0 * P / (dp * tp)

    out: Dict[str, float] = {}
    n_ar = strat.act_allreduce_per_layer if tp > 1 else 0
    if shape.kind == "train":
        if strat.fsdp_params and dp > 1:
            # all-gather the dp-sharded params (fwd + bwd), RS grads
            out["all_gather_params"] = 2 * p_shard * (dp - 1)
            out["reduce_scatter_grads"] = 2 * p_shard * (dp - 1)
        else:
            out["all_reduce_grads"] = 2 * (2.0 * P / tp) * (dp - 1) / dp
        out["all_reduce_acts"] = (n_ar * cfg.num_layers * T_dev * D * 2
                                  * 2 * g_tp)
    else:
        if strat.serve_fsdp and strat.fsdp_params and dp > 1:
            out["all_gather_params"] = p_shard * (dp - 1)
        out["all_reduce_acts"] = (n_ar * cfg.num_layers * T_dev * D * 2
                                  * 2 * g_tp)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# the three terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    total_flops: float
    tokens: float

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Perfect-overlap lower bound: the max term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.total_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-at-peak time / bound step time: the score we report.
        1.0 means every cycle is a useful model flop and nothing else binds."""
        ideal = self.model_flops / (CHIPS * hw.PEAK_FLOPS_BF16)
        return ideal / max(self.step_s, 1e-30)


def analyze(arch: str, shape_name: str,
            strat: Strategy = BASELINE) -> Roofline:
    cfg = get_config(arch)
    shp = SHAPES[shape_name]
    fl = cell_flops(cfg, shp)
    by = cell_bytes(cfg, shp, strat)
    co = cell_collectives(cfg, shp, strat)
    total_flops = fl["total"]
    if shp.kind == "train" and strat.remat_factor != 1.0:
        total_flops = fl["fwd"] + fl["bwd"] + strat.remat_factor * fl["fwd"]
    return Roofline(
        arch=arch, shape=shape_name,
        compute_s=total_flops / (CHIPS * hw.PEAK_FLOPS_BF16),
        memory_s=by["total"] / (CHIPS * hw.HBM_BW),
        collective_s=co["total"] / hw.NVLINK_BW_PER_LINK,
        model_flops=fl["model_flops"],
        total_flops=total_flops,
        tokens=fl["tokens"],
    )


def full_table(strat: Strategy = BASELINE) -> Dict[Tuple[str, str], Roofline]:
    from repro_torch.configs import all_cells
    return {(a, s): analyze(a, s, strat) for a, s in all_cells()}


def print_table(rows: Dict[Tuple[str, str], Roofline]) -> None:
    hdr = (f"{'arch':24s} {'shape':12s} {'compute':>10s} {'memory':>10s} "
           f"{'collect':>10s} {'bound':>10s} {'useful':>7s} {'roofl%':>7s}")
    print(hdr)
    for (a, s), r in rows.items():
        print(f"{a:24s} {s:12s} {r.compute_s:10.4f} {r.memory_s:10.4f} "
              f"{r.collective_s:10.4f} {r.bottleneck:>10s} "
              f"{r.useful_ratio:7.3f} {100*r.roofline_fraction:7.2f}")


def compare(arch: str, shape: str) -> None:
    print(f"== {arch} x {shape}: strategy comparison ==")
    print(f"{'strategy':22s} {'compute':>9s} {'memory':>9s} {'collect':>9s} "
          f"{'bound':>10s} {'step_s':>9s} {'roofl%':>7s}")
    for name, strat in STRATEGIES.items():
        r = analyze(arch, shape, strat)
        print(f"{name:22s} {r.compute_s:9.4f} {r.memory_s:9.4f} "
              f"{r.collective_s:9.4f} {r.bottleneck:>10s} {r.step_s:9.4f} "
              f"{100*r.roofline_fraction:7.2f}")


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--strategy", default="baseline",
                    choices=sorted(STRATEGIES))
    ap.add_argument("--compare", nargs=2, metavar=("ARCH", "SHAPE"),
                    help="print all strategies for one cell")
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
        return
    rows = full_table(STRATEGIES[args.strategy])
    if args.json:
        print(json.dumps({f"{a}|{s}": dataclasses.asdict(r)
                          for (a, s), r in rows.items()}, indent=1))
        return
    print_table(rows)


if __name__ == "__main__":
    main()
