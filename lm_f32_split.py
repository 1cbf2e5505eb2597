#!/usr/bin/env python3
"""Why a split f32 step of the Transformer LM lands ~1e-3 from one
card's: the same f32 step on part of the batch against f64, and the
FFN units whose ReLU the f32 rounding flips.

Run from the root of a checkout on a host with an NVIDIA GPU:

    python3 lm_f32_split.py

With chip_smoke's phase 16 weights and batch (``lm_variables`` of the
full-width LM at seed 20, the batch from seed 22, plain attention, no
clip) it prints, for rows 0-3, rows 4-7 and all 8 rows, each gradient
leaf's relative L2 distance from the same rows' f64 gradient (worst and
median), the distance of the two halves' mean from the whole batch's
f64 gradient (what a two-way data split computes), and per layer the
FFN pre-activations ``x @ w1 + b1`` whose sign differs between the f32
and f64 forwards.  The f64 forward keeps the port's f32 parts
(LayerNorm's statistics, the attention scores).  ``--device cpu`` runs
it at CPU_LM.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CPU_LM = dict(vocab_size=1001, hidden_size=64, num_heads=4,
              filter_size=128, num_layers=2)
CPU_BATCH, CPU_SEQ = 4, 64


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from chip_smoke import LM, LM_BATCH, LM_SEQ, lm_variables

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.utils import load_jax_variables

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = args.device
    lm, batch, seq = ((dict(LM), LM_BATCH, LM_SEQ) if dev != "cpu"
                      else (CPU_LM, CPU_BATCH, CPU_SEQ))
    variables = lm_variables(nn.Transformer(dropout=0.0, **lm), 20)
    rs = np.random.RandomState(22)
    x = rs.randint(0, lm["vocab_size"], (batch, seq)).astype(np.int64)
    y = rs.randint(0, lm["vocab_size"], (batch, seq)).astype(np.int64)
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion(logits=True))

    def run(rows, dtype):
        """Gradients and each layer's FFN pre-activations on ``rows``."""
        m = nn.Transformer(dropout=0.0, use_flash=False, **lm)
        load_jax_variables(m, variables)
        m = m.to(dev, dtype).train()
        pre = {}
        for i in range(lm["num_layers"]):
            def hook(mod, inp, out, i=i):
                with torch.no_grad():
                    pre[i] = (inp[0] @ mod.w1 + mod.b1).double().cpu()
            getattr(m, f"layer{i}").ffn.register_forward_hook(hook)
        loss = crit.forward(m(torch.from_numpy(x[rows]).to(dev)),
                            torch.from_numpy(y[rows]).to(dev))
        loss.backward()
        return ({k: p.grad.double().cpu().numpy()
                 for k, p in m.named_parameters()}, pre)

    def dist(a, b):
        e = {k: float(np.linalg.norm(a[k] - b[k])
                      / max(np.linalg.norm(b[k]), 1e-300)) for k in b}
        k = max(e, key=e.get)
        return {"worst": e[k], "leaf": k,
                "median": float(np.median(list(e.values())))}

    h = batch // 2
    res, grads = {"lm": lm, "batch": batch, "seq": seq}, {}
    for name, rows in (("rows 0-%d" % (h - 1), slice(0, h)),
                       ("rows %d-%d" % (h, batch - 1), slice(h, batch)),
                       ("all rows", slice(0, batch))):
        (g32, p32), (g64, p64) = run(rows, torch.float32), run(
            rows, torch.float64)
        grads[name] = (g32, g64)
        flips = {}
        for i in p32:
            f = (p32[i] > 0) != (p64[i] > 0)
            flips[f"layer{i}"] = {
                "units": int(f.sum()), "of": int(f.numel()),
                "abs_pre_f64": p64[i][f].abs().tolist()[:4]}
        res[name] = {"f32_vs_f64": dist(g32, g64), "relu_flips": flips}
        print(f"{name}: f32 gradient vs f64 {res[name]['f32_vs_f64']}; "
              f"ReLU flips {flips}", flush=True)
    (a32, _), (b32, _), (_, w64) = grads.values()
    mean = {k: (a32[k] + b32[k]) / 2 for k in a32}
    res["halves_mean_vs_all_f64"] = dist(mean, w64)
    print(f"the halves' f32 mean vs all rows in f64: "
          f"{res['halves_mean_vs_all_f64']}", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
