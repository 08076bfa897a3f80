"""Terminal demo: quenched SU(3) heatbath with a live plaquette strip.

Counterpart of latticeqcd_tpu/demo.py (itself the counterpart of the
reference's animated demo, src/demo/demo.jl:103-136, a 4^4 quenched heatbath
with live plots), rendered as a text sparkline so it needs no plotting
stack: the same lattice, coupling, start and output lines, on the port's
Heatbath with a torch.Generator seeded 0.

Run: python -m latticeqcd_torch.demo [nsweeps] [--device DEV]  (device ``cuda``
unless given)
"""

import sys

BARS = " ▁▂▃▄▅▆▇█"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print("usage: python -m latticeqcd_torch.demo [nsweeps] [--device DEV]")
            return 2
        device = argv[i + 1]
        del argv[i:i + 2]
    nsweeps = int(argv[0]) if argv else 60

    import torch

    from latticeqcd_torch.ops import fields, gauge_action as ga
    from latticeqcd_torch.updates.heatbath import Heatbath

    beta = 5.7
    lat = (4, 4, 4, 4)
    print(f"# quenched SU(3) heatbath demo: {lat} lattice, beta={beta}")
    u = fields.hot_start(lat, 3, seed=0, device=device)
    hb = Heatbath(action=ga.wilson_gauge_action(3, beta), use_or=True, num_or=2)
    generator = torch.Generator(device=device).manual_seed(0)
    history = []
    for i in range(1, nsweeps + 1):
        u = hb.update(u, generator)
        p = float(ga.mean_plaquette(u))
        history.append(p)
        lo, hi = 0.0, 0.7
        strip = "".join(
            BARS[min(len(BARS) - 1, max(0, int((v - lo) / (hi - lo) * (len(BARS) - 1))))]
            for v in history[-60:]
        )
        print(f"sweep {i:3d}  plaq={p:.5f}  {strip}")
    ntail = max(1, min(20, len(history) // 2))
    print(f"# thermalized <plaq> ~ {sum(history[-ntail:]) / ntail:.5f} (equilibrium ~ 0.561)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
