"""Does an op give a row shard the whole image's bits?  On the card, in bf16 and float32.

Image rows over ranks (``parallel/halo.py``) compute each op on a shard and
its halo rows; a (1, S) step reproduces one process's bf16 losses only as
far as these agree bit for bit with the whole image's op.  For each of a
few convolutions of the stage-1 networks at 640x192 (batch 8; the shard:
rank 0 of 2, its halo as ``models/layers.py:Conv2d`` takes it) and for the
bilinear ``align_corners=True`` resize of the grid's encoding (the shard's
arithmetic of ``resize_bilinear_align_corners``: the columns resized, then
two source rows blended), prints the share of the shard's output elements
that differ from the whole image's rows and the largest difference.

    python scripts/shard_bits.py            # on the card (cuda)
    python scripts/shard_bits.py --cpu      # the same on the CPU
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

# (name, in channels, out channels, kernel, stride, padding, rows, columns)
CONVS = (
    ("stem 7x7/2", 3, 64, 7, 2, 3, 192, 640),
    ("layer1 3x3", 64, 64, 3, 1, 1, 48, 160),
    ("layer1 1x1", 256, 64, 1, 1, 0, 48, 160),
    ("layer2 3x3/2", 128, 128, 3, 2, 1, 48, 160),
    ("layer3 3x3", 256, 256, 3, 1, 1, 12, 40),
    ("decoder 3x3", 32, 16, 3, 1, 1, 192, 640),
)
BATCH = 8


def compare(shard, whole):
    diff = (shard.float() - whole.float()).abs()
    return {"share_differing": float((diff > 0).float().mean()), "max_abs": float(diff.max())}


def conv_bits(dev, dtype, seed=0):
    out = {}
    g = torch.Generator().manual_seed(seed)
    for name, cin, cout, k, stride, pad, rows, cols in CONVS:
        x = torch.randn((BATCH, cin, rows, cols), generator=g).to(dev, dtype)
        w = (torch.randn((cout, cin, k, k), generator=g) / (cin * k * k) ** 0.5).to(dev, dtype)
        whole = F.conv2d(x, w, None, stride, pad)
        h = rows // 2
        below = max(0, k - 1 - pad - stride + 1)
        # rank 0: the zero pad above the image, the next rank's rows below
        part = F.pad(x[:, :, :h + below], (0, 0, pad, 0))
        shard = F.conv2d(part, w, None, stride, (0, pad))
        out[name] = compare(shard, whole[:, :, :shard.shape[-2]])
    return out


def resize_bits(dev, dtype, seed=0):
    """The grid encoding (8 channels at 192x640) resized to each scale of the
    decoder: rank 0's rows by the shard's arithmetic against the whole
    image's ``F.interpolate``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((BATCH, 8, 192, 640), generator=g).to(dev, dtype)
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    out = {}
    for scale in (2, 4, 8, 16, 32):
        size = (192 // scale, 640 // scale)
        whole = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
        h_in, h_out = 192, size[0]
        pos = torch.tensor(h_in - 1, dtype=wide) / (h_out - 1) * torch.arange(h_out, dtype=wide)
        i0 = pos.long()
        i1 = torch.clamp_max(i0 + 1, h_in - 1)
        mine = slice(0, h_out // 2)
        lam = (pos - i0)[mine][:, None].to(dev)
        ext = x.to(wide)
        ext = F.interpolate(ext, size=(ext.shape[-2], size[1]), mode="bilinear",
                            align_corners=True)
        a, b = (ext[..., i[mine].to(dev), :] for i in (i0, i1))
        shard = ((1.0 - lam) * a + lam * b).to(dtype)
        out[f"1/{scale}"] = compare(shard, whole[:, :, mine])
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()
    if args.cpu:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no card: pass --cpu to run on the CPU")
        dev = torch.device("cuda")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "CPU"
    for dtype in (torch.bfloat16, torch.float32):
        print(json.dumps({"device": name, "dtype": str(dtype), "convs": conv_bits(dev, dtype),
                          "resize": resize_bits(dev, dtype)}))


if __name__ == "__main__":
    main()
