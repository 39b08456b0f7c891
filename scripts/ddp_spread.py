"""How far two data-parallel ranks part from one process over a few training steps, on one NVIDIA GPU.

    PYTHONPATH=. python scripts/ddp_spread.py

Runs ``chip_smoke.py``'s ddp steps (stage 1: ResNet-50, DenseASPP, 49+14
planes, VGG19, 640x192, seeded weights, the global batch of 4 flipped to 8,
3 steps) as two gloo ranks sharing the card and, beside them, as one process
on the global batch twice, in bf16 and in float32 with TF32 off.  Prints, for
each arithmetic and step, every loss's relative difference of the ranks from
the one process and of the one process's repeat from itself, the first
step's leaves whose gradients part most (relative L2), and the largest
parameter difference after the steps, beside the card's name and power
limit; the summary is the last line, one JSON object.  Needs CUDA.
"""
import json
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402


def by_loss(a, b):
    return [{k: abs(x[k] / v - 1) for k, v in y.items() if v}
            for x, y in zip(a["losses"], b["losses"])]


def worst_grads(a, b, n=6):
    """The first step's ``n`` leaves whose gradient in ``a`` is farthest from
    ``b``'s, relative L2 (leaves whose gradient is not 0)."""
    rel = {k: ((a["grads"][k] - g).norm() / g.norm()).item()
           for k, g in b["grads"].items() if g.abs().max().item() > 1e-6}
    return dict(sorted(rel.items(), key=lambda kv: -kv[1])[:n])


def largest_param_diff(a, b):
    return max((a["state"][k].double() - b["state"][k].double()).abs().max().item()
               for k in b["first"])


def main():
    card = cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda", 0)
    out = {"card": card}
    runs = cs.run_ddp_ranks(dev)
    for bf16 in (True, False):
        tag = "bf16" if bf16 else "float32"
        r0, _, one = runs.pop(tag)
        again = cs.ddp_steps(dev, 0, 1, bf16=bf16)
        out[tag] = {"ranks_vs_one": by_loss(r0, one), "one_vs_itself": by_loss(again, one),
                    "grad_l2_rel_ranks_vs_one": worst_grads(r0, one),
                    "grad_l2_rel_one_vs_itself": worst_grads(again, one),
                    "param_max_ranks_vs_one": largest_param_diff(r0, one),
                    "param_max_one_vs_itself": largest_param_diff(again, one),
                    "one_total_loss": [s["loss/total_loss"] for s in one["losses"]]}
        print(f"[ddp_spread] {tag}: {json.dumps(out[tag])} | {card}", flush=True)
        del r0, one, again
        cs.free_cache()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
