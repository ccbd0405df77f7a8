"""The plume scene of a rollout mix ("scene": "plume"): an empty res^3
domain walled by one obstacle cell, the plume inflow of sim.simulate.
create_plume_bcs at the bottom, and the mix's obstacles (boxes and
spheres of fixed sizes, their centres drawn from the seed, uniform
between centre_low and centre_high in shares of the extent, so every
seed gives the same work in another place). The first state is at
rest."""

import numpy as np
import torch

from fluidbench.scenes.shapes import (TYPE_OBSTACLE, empty_flags, plume_bcs,
                                      solids)


def make(mix, seed, device):
    """{"u", "p", "density", "flags", "bcs"} of the mix at `seed`."""
    rng = np.random.default_rng(seed)
    res, b = mix["res"], mix["batch"]
    shape = (res, res, res)
    flags = empty_flags(b, shape, device)
    for ob in mix["obstacles"]:
        lo, hi = np.asarray(ob["centre_low"]), np.asarray(ob["centre_high"])
        centre = [int(round(c * res)) for c in lo + (hi - lo) * rng.random(3)]
        size = int(round(ob.get("half_extent", ob.get("radius")) * res))
        solid = solids(torch.tensor([ob["kind"] == "box"], device=device),
                       torch.tensor([size], device=device),
                       torch.tensor([centre], device=device), shape)
        flags = torch.where(solid[:, None], TYPE_OBSTACLE, flags)
    zeros = dict(device=device, dtype=torch.float32)
    pl = mix["plume"]
    return {"u": torch.zeros((b, 3) + shape, **zeros),
            "p": torch.zeros((b, 1) + shape, **zeros),
            "density": torch.zeros((b, 1) + shape, **zeros),
            "flags": flags.to(torch.int32).contiguous(),
            "bcs": plume_bcs(b, shape, pl["density"], pl["u_scale"],
                             pl["radius"], device)}
