"""The layout probe on the card (counterpart of tools/kernel4d_probe.py).

A flash kernel can read the projection output (B, S, H, D) in place, or
the model can pay the merge transposes to (B*H, S, D) around every call.
This tool prices that choice on the card with the three layout kernels of
`ops/kernels/probe.py` (one-shot softmax attention per head, no mask):

- `4d`: the (B, S, H, D) kernel;
- `fold3d`: the same on (B, S, H*D), head h at lanes h*D;
- `merged`: the same on pre-merged (B*H, S, D), with the merge copies of
  q, k and v and the unmerge copy of the output paid on every call.

Each arm is checked against `reference` (the JAX tool's oracle, in
torch) and timed as the JAX tool times it: a chain of UNROLL calls, each
feeding the next (`acc`) and perturbing k and v by `acc * eps` so that
every call depends on the one before it.  Beside the three arms stand
the same chain through the port's `flash_forward` on the 4D layout, and
through `torch.nn.functional.scaled_dot_product_attention` on
`.transpose(1, 2)` views (the library yardstick), and the four merge
copies of one call alone.  Each chain is captured once in a CUDA graph;
the graphs are replayed in turns, and a chain's time is the least of its
four replays over UNROLL.

    python -m paddle_tpu_torch.tools.kernel4d_probe          # on the card
    python -m paddle_tpu_torch.tools.kernel4d_probe --cpu    # plain versions

prints one JSON line and exits non-zero when an arm fails to build or
run, or is off the reference by more than TOL.  With `--cpu` (or
`run(..., device="cpu")`) the wrappers run their plain versions, which
are checked against the reference (the JAX tool's CPU branch).
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from ..device import resolve
from ..ops.kernels import attention as A
from ..ops.kernels import probe as P

UNROLL = 8
EPS = 1e-8
TOL = 0.05


def reference(q4, k4, v4):
    """kernel4d_probe.py's `reference`: softmax attention per head on
    (B, S, H, D), scores in f32, the probabilities cast to v's dtype."""
    scale = 1.0 / (q4.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q4.float(), k4.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v4.dtype).float(),
                        v4.float()).to(v4.dtype)


def inputs(B, S, H, D, device):
    """q, k, v (B, S, H, D) bf16: randn * 0.3 from RandomState(0), as the
    JAX tool makes them."""
    r = np.random.RandomState(0)
    return tuple(torch.from_numpy(r.randn(B, S, H, D) * 0.3).to(
        device=device, dtype=torch.bfloat16) for _ in range(3))


def graphs_ms(fns, calls, replays=4):
    """ms per call of each of `fns` ({key: fn}, each fn making `calls`
    calls): each is warmed up once on a side stream, captured once into
    a CUDA graph and replayed once untimed; then the graphs are replayed
    in turns, forward and backward order by round, `replays` rounds, and
    each keeps the least of its replays (CUDA events), over `calls`.  The
    host's dispatch is not in the times, and the turns keep the card's
    clocks from favouring whichever graph runs first."""
    graphs = {}
    for key, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            fn()
        g.replay()
        graphs[key] = g
    best = {key: float("inf") for key in graphs}
    order = list(graphs)
    for r in range(replays):
        for key in (order if r % 2 == 0 else order[::-1]):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            graphs[key].replay()
            e1.record()
            e1.synchronize()
            best[key] = min(best[key], e0.elapsed_time(e1))
    return {key: ms / calls for key, ms in best.items()}


def card():
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {type(e).__name__}"
    return out[0] if out else "nvidia-smi printed nothing"


def _perturbed(x, acc):
    return torch.add(x, acc, alpha=EPS)


def chains(q4, k4, v4):
    """The chains the tool times, by result key: each makes UNROLL calls
    from q4, k4, v4 (B, S, H, D)."""
    B, S, H, D = q4.shape
    to3 = lambda x: x.view(B, S, H * D)
    merge = P.merge_heads
    unmerge = lambda x: P.unmerge_heads(x, H).contiguous()

    def chain_4d():
        acc = q4
        for _ in range(UNROLL):
            acc = P.probe_4d(acc, _perturbed(k4, acc), _perturbed(v4, acc))
        return acc

    def chain_fold3d():
        # the natural layout: no reshape copies at all between calls
        q3, k3, v3 = to3(q4), to3(k4), to3(v4)
        acc = q3
        for _ in range(UNROLL):
            acc = P.probe_fold3d(acc, _perturbed(k3, acc),
                                 _perturbed(v3, acc), H)
        return acc

    def chain_merged():
        # the merge copies of q, k and v and the unmerge copy of the
        # output, on every call, as a layer that reads (B*H, S, D) pays
        acc = q4
        for _ in range(UNROLL):
            out = P.probe_merged(merge(acc), merge(_perturbed(k4, acc)),
                                 merge(_perturbed(v4, acc)))
            acc = unmerge(out)
        return acc

    def chain_flash():
        acc = q4
        for _ in range(UNROLL):
            acc = A.flash_forward(acc, _perturbed(k4, acc),
                                  _perturbed(v4, acc))[0]
        return acc

    def chain_sdpa():
        sdpa = torch.nn.functional.scaled_dot_product_attention
        acc = q4
        for _ in range(UNROLL):
            acc = sdpa(acc.transpose(1, 2),
                       _perturbed(k4, acc).transpose(1, 2),
                       _perturbed(v4, acc).transpose(1, 2)).transpose(1, 2)
        return acc

    def chain_copies():
        # the merged chain's four copies of one call, without the kernel
        acc = q4
        for _ in range(UNROLL):
            qm, _, _ = merge(acc), merge(k4), merge(v4)
            acc = unmerge(qm)
        return acc

    return {"per_call_ms_4d": chain_4d,
            "per_call_ms_fold3d": chain_fold3d,
            "per_call_ms_merged_incl_transpose": chain_merged,
            "per_call_ms_flash_fwd": chain_flash,
            "per_call_ms_sdpa": chain_sdpa,
            "per_call_ms_merge_copies": chain_copies}


ARM_CHAINS = {"4d": "per_call_ms_4d", "fold3d": "per_call_ms_fold3d",
              "merged": "per_call_ms_merged_incl_transpose"}


def arms(q4, k4, v4):
    """Each arm once on q4, k4, v4, its output as (B, S, H, D)."""
    B, S, H, D = q4.shape
    to3 = lambda x: x.view(B, S, H * D)
    m = P.merge_heads
    return {
        "4d": lambda: P.probe_4d(q4, k4, v4),
        "fold3d": lambda: P.probe_fold3d(to3(q4), to3(k4), to3(v4),
                                         H).view(B, S, H, D),
        "merged": lambda: P.unmerge_heads(
            P.probe_merged(m(q4), m(k4), m(v4)), H)}


def run(B=8, S=512, H=12, D=64, device=None):
    """The probe at (B, S, H, D); returns the result dict (see the module
    docstring).  On the card each arm's kernel launches 1 + 2 * UNROLL
    times (the check, the chain's warm-up and its capture; replays are
    not counted) and `flash_fwd` 2 * UNROLL times."""
    dev = resolve(device)
    q4, k4, v4 = inputs(B, S, H, D, dev)
    ref = reference(q4, k4, v4).float()
    shape = {"B": B, "S": S, "H": H, "D": D}
    if dev.type != "cuda":
        out = {"mode": "cpu-plain", **shape}
        for key, fn in arms(q4, k4, v4).items():
            out[f"max_err_{key}"] = float((fn().float() - ref).abs().max())
        out["ok"] = all(out[f"max_err_{k}"] < TOL for k in ARM_CHAINS)
        return out

    # build/run status and numeric error are separate answers, as in the
    # JAX tool: a kernel that fails to build is another diagnosis from
    # one that runs and disagrees
    builds, errs = {}, {}
    for key, fn in arms(q4, k4, v4).items():
        try:
            o = fn()
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported in the result
            builds[key] = f"{type(e).__name__}: {str(e)[:300]}"
            continue
        builds[key] = True
        errs[key] = float((o.float() - ref).abs().max())
    usable = {k for k in ARM_CHAINS if builds[k] is True and errs[k] < TOL}
    out = {"mode": "gpu", "device": torch.cuda.get_device_name(dev),
           "card": card(), "builds": builds, "max_err": errs, **shape,
           "unroll": UNROLL}
    timed = {key: fn for key, fn in chains(q4, k4, v4).items()
             if key not in ARM_CHAINS.values()
             or any(ARM_CHAINS[a] == key for a in usable)}
    out.update(graphs_ms(timed, UNROLL))
    out["ok"] = usable == set(ARM_CHAINS)
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out = run(device="cpu" if "--cpu" in argv else None)
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
