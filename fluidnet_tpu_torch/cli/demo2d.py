"""2-D realtime demo, headless edition, on the card.

Port of fluidnet_tpu.cli.demo2d (the reference's
`qlua -lenv fluid_net_2d_demo.lua`): a 2-D plume with RGB density and
optional scripted force splats, written out as PNG frames. Every step is
sim.simulate.simulate: each density channel and the velocity advected
through the windowed warp (K5), then the projection.

  python -m fluidnet_tpu_torch.cli.demo2d --res 128 --frames 256 \\
      --model data/models_bundled/m2d --out_dir data/output/demo2d_torch

`--device cpu` runs on the CPU (the kernels' plain versions).
"""

import argparse
import os
import struct
import time
import zlib

import numpy as np
import torch

from fluidnet_tpu_torch.core.config import ModelConfig
from fluidnet_tpu_torch.core.grids import (FluidState, empty_domain,
                                           resolve_device)
from fluidnet_tpu_torch.models.fluidnet import FluidNet, random_model
from fluidnet_tpu_torch.sim.simulate import (FlagConsts, create_plume_bcs,
                                             simulate)
from fluidnet_tpu_torch.utils.checkpoint import load_mconf, load_params

PLUME_RGB = [1.0, 0.8, 0.3]
TOGGLE_ALIASES = {"vorticity": "vorticity_confinement_amp",
                  "buoyancy": "buoyancy_scale", "gravity": "gravity_scale",
                  "advection": "advection_method"}


def png_bytes(rgb, level=6):
    """Minimal PNG encoder (8-bit RGB, no dependencies). rgb (h, w, 3)
    uint8."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + \
            struct.pack(">I", zlib.crc32(c) & 0xffffffff)

    hdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr) +
            chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def write_png(path, rgb):
    """Writes rgb (h, w, 3) uint8 as an 8-bit RGB PNG."""
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))


def sphere_force_splat(state, center_yx, force_yx, radius):
    """Mouse-splat equivalent: adds a smoothstep-falloff force blob to U
    (lib/emitter.lua sphereForceFalloff, fluid_net_2d_demo.lua:556-594)."""
    _, _, Z, Y, X = state.u.shape
    yy, xx = np.meshgrid(np.arange(Y), np.arange(X), indexing="ij")
    d = np.sqrt((yy - center_yx[0]) ** 2 + (xx - center_yx[1]) ** 2) / radius
    t = np.clip(1.0 - d, 0.0, 1.0)
    fall = (t * t * (3 - 2 * t)).astype(np.float32)  # smoothstep
    du = np.zeros(state.u.shape, np.float32)
    du[0, 0, 0] = force_yx[1] * fall
    du[0, 1, 0] = force_yx[0] * fall
    return state.replace(u=state.u + torch.from_numpy(du).to(state.u.device))


def density_to_rgb(density):
    """density (c, y, x) in [0, 1], 1 or 3 channels -> (y, x, 3) uint8,
    y flipped to image rows."""
    d = np.asarray(density)
    if d.shape[0] == 1:
        d = np.repeat(d, 3, axis=0)
    img = np.clip(d[:3], 0, 1).transpose(1, 2, 0)
    return (img[::-1] * 255).astype(np.uint8)


def state_rgb(state):
    """The first sample's density as an image (one device-to-host copy)."""
    return density_to_rgb(state.density[0, :, 0].cpu().numpy())


def save_velocity_quiver(path, u, density=None, stride=4):
    """Velocity-arrow picture (the GL drawVelocityField, tfluids.cc:350-424);
    needs matplotlib, imported here."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    ux, uy = u[0, 0, 0].cpu().numpy(), u[0, 1, 0].cpu().numpy()
    Y, X = ux.shape
    fig, ax = plt.subplots(figsize=(5, 5))
    if density is not None:
        ax.imshow(density_to_rgb(density[0, :, 0].cpu().numpy()),
                  origin="lower", extent=(0, X, 0, Y))
    yy, xx = np.mgrid[0:Y:stride, 0:X:stride]
    ax.quiver(xx, yy, ux[::stride, ::stride], uy[::stride, ::stride],
              color="w" if density is not None else "k", scale=30)
    ax.set_xlim(0, X)
    ax.set_ylim(0, Y)
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.savefig(path, dpi=100)
    plt.close(fig)


def parse_toggle_script(spec):
    """Parses '40:sim_method=jacobi;80:dt=0.05,vorticity=2' into
    {frame: {field: value}}: the reproducible stand-in for the reference
    demo's keyboard toggles (fluid_net_2d_demo.lua:203-287)."""
    events = {}
    if not spec:
        return events
    for part in spec.split(";"):
        frame_s, kvs = part.split(":", 1)
        ev = {}
        for kv in kvs.split(","):
            k, v = kv.split("=", 1)
            k = TOGGLE_ALIASES.get(k.strip(), k.strip())
            vs = v.strip()
            if vs.lstrip("-").isdigit():
                v = int(vs)
            else:
                try:
                    v = float(vs)
                except ValueError:
                    v = vs
            if k == "plume":
                v = v in ("1", "on", "true", 1.0)
            ev[k] = v
        events[int(frame_s)] = ev
    return events


def load_model(path, device):
    """(mconf, FluidNet) of a 2-D checkpoint directory."""
    mconf = load_mconf(path)
    if mconf.is_3d:
        raise ValueError(f"{path} holds a 3-D model; the demo needs 2-D")
    return mconf, FluidNet(mconf, device=device).load_jax_params(
        load_params(path))


def initial_state(res, device):
    """A res^2 box with an obstacle border, at rest, with RGB density."""
    shape = (1, 1, 1, res, res)
    return FluidState(
        u=torch.zeros((1, 2, 1, res, res), device=device),
        p=torch.zeros(shape, device=device),
        flags=empty_domain(shape, False, device=device),
        density=torch.zeros((1, 3, 1, res, res), device=device))


def plume_bcs(state):
    return create_plume_bcs(state, PLUME_RGB, u_scale=0.6, rad=0.15)


def run(args):
    dev = resolve_device(args.device)
    res = args.res
    toggles = parse_toggle_script(args.script)
    if args.model:
        mconf, model = load_model(args.model, dev)
        mconf = mconf.replace(sim_method="convnet")
    else:
        mconf = ModelConfig(is_3d=False, sim_method=args.sim_method)
        model = random_model(mconf, 0, dev) \
            if args.sim_method == "convnet" else None
    mconf = mconf.replace(dt=args.dt, buoyancy_scale=1.0,
                          vorticity_confinement_amp=args.vorticity,
                          advection_method="maccormackOurs",
                          max_iter=args.max_iter)

    rng = np.random.default_rng(0)
    state = initial_state(res, dev)
    bcs = plume_bcs(state)
    consts = FlagConsts()

    os.makedirs(args.out_dir, exist_ok=True)
    t_start = time.perf_counter()
    n_img = 0
    for i in range(args.frames):
        if i in toggles:
            ev = dict(toggles[i])
            plume = ev.pop("plume", None)
            if plume is not None:
                bcs = plume_bcs(state) if plume else None
            if ev:
                if ev.get("sim_method") == "convnet" and model is None:
                    model = random_model(mconf, 0, dev)
                mconf = mconf.replace(**ev)
            print(f"  frame {i}: toggled {toggles[i]}")
        if args.splats and i % 40 == 20:
            c = (rng.integers(res // 4, 3 * res // 4),
                 rng.integers(res // 4, 3 * res // 4))
            f = (rng.standard_normal() * 2, rng.standard_normal() * 2)
            state = sphere_force_splat(state, c, f, radius=res / 10)
        state = simulate(state, mconf, model if mconf.sim_method ==
                         "convnet" else None, bcs, consts=consts)
        if i % args.save_every == 0:
            write_png(os.path.join(args.out_dir, f"frame_{i:05d}.png"),
                      state_rgb(state))
            if args.draw_velocity:
                save_velocity_quiver(
                    os.path.join(args.out_dir, f"vel_{i:05d}.png"),
                    state.u, state.density)
            n_img += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    fps = args.frames / (time.perf_counter() - t_start)
    print(f"demo2d: {args.frames} frames at {res}^2 on {dev}, {fps:.1f} fps "
          f"({mconf.sim_method}); wrote {n_img} PNGs to {args.out_dir}")
    return fps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--save_every", type=int, default=8)
    ap.add_argument("--dt", type=float, default=0.1)
    ap.add_argument("--vorticity", type=float, default=0.0)
    ap.add_argument("--max_iter", type=int, default=34)
    ap.add_argument("--sim_method", default="convnet",
                    choices=["convnet", "jacobi", "pcg"])
    ap.add_argument("--model", default="")
    ap.add_argument("--splats", action="store_true",
                    help="periodic scripted force splats")
    ap.add_argument("--draw_velocity", action="store_true",
                    help="also write velocity-arrow overlays (needs "
                         "matplotlib)")
    ap.add_argument("--out_dir", default="data/output/demo2d")
    ap.add_argument("--script", default="", help="runtime toggle script "
                    "'FRAME:key=val,key=val;FRAME:...' - keys: sim_method, "
                    "advection, dt, plume, buoyancy, gravity, vorticity, "
                    "max_iter (fluid_net_2d_demo.lua:203-287)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    return run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
