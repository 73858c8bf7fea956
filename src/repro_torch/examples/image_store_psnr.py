"""Multimedia evaluation (the paper's application-level story): store an
image through the EXTENT memory at each quality level and report PSNR
against write energy — the accuracy/energy tradeoff of section IV.C.

  PYTHONPATH=src python -m repro_torch.examples.image_store_psnr \
      [--device cuda|cpu]

The image is a synthetic multi-frequency test card (no external data);
its grayscale average (the paper's Fig. 10 pseudo-code, which tags the
result low-priority) is stored as float32 payloads through
``repro_torch.memory.write`` with the eager ``oracle`` backend.
"""
import argparse
import math
from typing import Optional

import torch

from repro_torch import memory, rng
from repro_torch.core.energy_model import exact_baseline_energy_pj
from repro_torch.core.priority import Priority
from repro_torch.device import resolve_device

LEVELS = (Priority.LOW, Priority.MID, Priority.HIGH, Priority.EXACT)


def test_card(n: int = 256, device=None) -> torch.Tensor:
    """Synthetic RGB image with smooth and high-frequency content, in
    [0, 1], (n, n, 3) float32. The grid is ``jnp.linspace(0, 1, n)``'s,
    ``i * f32(1 / (n - 1))``."""
    lin = torch.arange(n, dtype=torch.float32, device=device) * \
        torch.tensor(1 / (n - 1), dtype=torch.float32, device=device)
    y, x = torch.meshgrid(lin, lin, indexing="ij")
    pi = math.pi
    r = 0.5 + 0.5 * torch.sin(7 * pi * x) * torch.cos(3 * pi * y)
    g = torch.clip(x + 0.2 * torch.sin(31 * pi * y), 0, 1)
    b = torch.clip(1 - y + 0.1 * torch.sin(61 * pi * x * y), 0, 1)
    return torch.stack([r, g, b], -1)


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(torch.mean((a - b) ** 2))
    return 99.0 if mse == 0 else 10 * math.log10(1.0 / mse)


def store(gray: torch.Tensor, level: Priority):
    """``gray`` written over zeros at ``level`` through the oracle:
    (stored, host stats)."""
    stored, st = memory.write(rng.PRNGKey(0), torch.zeros_like(gray), gray,
                              level=level, backend="oracle")
    return stored, st.host_dict()


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or "
                    "cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    img = test_card(device=dev)
    # Fig. 10: the grayscale-average transform tags the result
    # low-priority — payload the application tolerates errors in
    gray = torch.mean(img, dim=-1)
    print(f"{'level':8s} {'PSNR(dB)':>9s} {'energy(uJ)':>11s} "
          f"{'vs basic':>9s} {'bit errors':>11s}")
    low_psnr = None
    for level in LEVELS:
        stored, h = store(gray, level)
        baseline = exact_baseline_energy_pj(int(h["bits_total"]))
        p = psnr(gray, stored)
        if level == Priority.LOW:
            low_psnr = p
        print(f"{level.name:8s} {p:9.2f} "
              f"{h['energy_pj']/1e6:11.3f} "
              f"{100*(1-h['energy_pj']/baseline):8.1f}% "
              f"{h['bit_errors']:11d}")
    # the paper's qualitative claim: even LOW keeps the image "not
    # visually noticeable" (PSNR > ~30 dB) while saving most of the
    # write energy
    assert low_psnr > 30.0, "LOW level must stay perceptually fine"
    print("OK: LOW-priority storage keeps PSNR above 30 dB")


if __name__ == "__main__":
    main()
