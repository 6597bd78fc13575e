"""Quickstart on the PyTorch/CUDA port (src/repro_torch): the Randomized
Quantization Mechanism in five minutes (counterpart of
examples/quickstart.py).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

On the GPU (``--device cuda``, the default: the encodes run the CUDA
kernels) or the CPU (``--device cpu``: their plain versions). The port
encodes at explicit uint32 seeds where the reference splits JAX keys.
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.core import RQMParams, decode_sum, make_mechanism, mechanism_names  # noqa: E402
from repro_torch.core.distribution import rqm_outcome_distribution  # noqa: E402
from repro_torch.core.pbm import PBMParams  # noqa: E402
from repro_torch.core.renyi import pbm_aggregate_epsilon, rqm_aggregate_epsilon  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def uniform(shape, seed: int, device) -> torch.Tensor:
    """float32 uniform on [-1, 1) from a generator on ``device``."""
    g = torch.Generator(device).manual_seed(seed)
    return torch.rand(shape, generator=g, device=device) * 2.0 - 1.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    device = torch.device(ap.parse_args(argv).device)

    # --- 1. quantize a "gradient" privately -------------------------------
    params = RQMParams(c=1.0, delta=1.0, m=16, q=0.42)  # paper's Sec-6 settings
    print(f"RQM: m={params.m} levels on [-{params.x_max}, {params.x_max}], "
          f"{params.bits_per_coordinate:.0f} bits/coordinate, "
          f"eps_inf <= {params.epsilon_infinity():.2f} (Thm 5.2)")
    grad = uniform((100_000,), 0, device)
    levels = ops.rqm_fast(grad, 1, params)  # int32 in [0, 15]
    print(f"quantized {grad.numel()} coords -> int levels, "
          f"range [{int(levels.min())}, {int(levels.max())}]")

    # --- 2. SecAgg + decode: the server only sees the SUM ------------------
    n_clients = 24
    grads = uniform((n_clients, 4096), 2, device)
    z = torch.stack([ops.rqm_fast(grads[i], 3 + i, params) for i in range(n_clients)])
    g_hat = decode_sum(z.sum(0, dtype=torch.int32), n_clients, params)
    err = float((g_hat - grads.mean(0)).abs().mean())
    print(f"decode(sum(z)) vs true mean gradient: mean |err| = {err:.4f} "
          f"(unbiased; averages out over {n_clients} clients)")

    # --- 3. exact outcome distribution (Lemma 5.1) -------------------------
    pmf = rqm_outcome_distribution(0.37, params)
    print(f"Lemma 5.1 pmf at x=0.37: sums to {pmf.sum():.12f}, "
          f"E[B(z)] = {(pmf * params.levels()).sum():.4f}")

    # --- 4. the paper's headline: better Renyi DP than PBM ------------------
    eps = {}
    for alpha in (2.0, 32.0):
        e_rqm = rqm_aggregate_epsilon(params, n=40, alpha=alpha)
        e_pbm = pbm_aggregate_epsilon(PBMParams(c=1.0, m=16, theta=0.25), 40, alpha)
        eps[alpha] = (e_rqm, e_pbm)
        print(f"alpha={alpha:4.0f}, n=40: eps RQM={e_rqm:.3f} < PBM={e_pbm:.3f} "
              f"({e_pbm / e_rqm:.1f}x better)")

    # --- 5. Mechanism API v2: registry-backed, self-accounting --------------
    print(f"registered mechanisms: {', '.join(mechanism_names())}")
    for spec in ("rqm:c=1.0,m=16,q=0.42", "pbm:c=1.0,theta=0.25", "qmgeo:c=1.0,m=16,r=0.6"):
        mech = make_mechanism(spec)
        mech.quantize(grad[:4096], 6)
        print(f"  {mech.describe():45s} -> per-round eps(alpha=8, n=40) = "
              f"{mech.per_round_epsilon(40, 8.0):.3f}, {mech.bits:.0f} bits/coord")
    return {"levels": levels, "decode_err": err, "eps": eps}


if __name__ == "__main__":
    main()
