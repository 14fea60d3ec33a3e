"""A cell's program and inputs, made from its configuration, its traffic
mix and the run's seed.

The program is built through its normal entry points:
`models.create_backbone`, `core.prior.make_flat_target`,
`methods.get_runner_cls` and `data.ArrayLoader`.  The weights and the data
are the benchmark's own: drawn on the device from the seed in a few large
calls, and handed alike to the program and to the reference.
`make_flat_target` draws the backbone's initial weights on the host as
well; the runner is given the benchmark's instead.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import layout as layout_mod
from benchmark.reference import sampler

# tags of the seed's derived streams
DATA, LABELS, THETA, COMPONENT, LIKELIHOOD, LOADER, CHECK, HOST_INIT = \
    range(101, 109)


def derived_seed(seed: int, *tags: int) -> int:
    return sampler.splitmix_seed(seed, *tags)


def device_generator(device, seed: int, *tags: int) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(derived_seed(seed, *tags))
    return g


def images(config: dict, n: int, seed: int, tag: int, device):
    """n NHWC float32 images (standard normal pixels, as normalised images
    are) and their labels, drawn on the device and returned as host numpy
    arrays: data held in host memory, as a user's in-memory set is."""
    side, ch = config["image_size"], config["num_channels"]
    x = torch.randn((n, side, side, ch), generator=device_generator(
        device, seed, DATA, tag), device=device)
    y = torch.randint(0, config["num_classes"], (n,), generator=
                      device_generator(device, seed, LABELS, tag),
                      device=device)
    return x.cpu().numpy(), y.cpu().numpy().astype(np.int32)


def theta(layout: layout_mod.Layout, seed: int, device) -> torch.Tensor:
    """The initial flat vector: each kernel normal with std sqrt(1/fan_in)
    (the readout sqrt(2/fan_in)), the position embedding std 0.02, biases
    and shifts 0, scales 1, the padding 0."""
    mean, std = layout.init_vectors(device)
    z = torch.randn(layout.dim, generator=device_generator(device, seed,
                                                           THETA),
                    device=device)
    return mean.add_(std.mul_(z))


def components(layout, base: torch.Tensor, traffic: dict, seed: int,
               device):
    """{cycle: {"mean", "var", "likelihoods"}} of traffic["components"]
    completed cycles, host numpy, as the cycle ends leave them: mean_c =
    base + s eps_c and sd_c = s u_c, u_c ~ U[0.5, 1.5), with s =
    traffic["component_scale"] times each leaf's initial std (times 0.1 on
    the leaves that start constant) and 0 on the padding; nst
    likelihoods each, exp(-U[lo, hi))."""
    _, std = layout.init_vectors(device)
    s = torch.where(std > 0, std, 0.1) * traffic["component_scale"]
    s[layout.n_params:] = 0.0
    lo, hi = traffic["likelihood_nll"]
    rng = np.random.default_rng(derived_seed(seed, LIKELIHOOD))
    out = {}
    for c in range(1, traffic["components"] + 1):
        g = device_generator(device, seed, COMPONENT, c)
        mean = base + s * torch.randn(layout.dim, generator=g, device=device)
        sd = s * (0.5 + torch.rand(layout.dim, generator=g, device=device))
        out[c] = {"mean": mean.cpu().numpy(), "var": (sd * sd).cpu().numpy(),
                  "likelihoods": np.exp(-rng.uniform(lo, hi,
                                                     traffic["nst"]))}
    return out


def port_config(config: dict, traffic: dict, seed: int, device):
    from bayesdll_tpu_torch.config import Config
    hparams = dict(config["hparams"])
    if "nst" in traffic:
        hparams["nst"] = str(traffic["nst"])
    return Config(
        method=traffic["method"], hparams=hparams, dataset="synthetic",
        backbone=config["backbone"], num_classes=config["num_classes"],
        batch_size=config["batch_size"], lr=config["lr"],
        compute_dtype=config["compute_dtype"], epochs=traffic["epochs"],
        num_cycles=traffic["num_cycles"],
        proportion_exploration=traffic["proportion_exploration"], seed=seed,
        device=str(device))


def target(cfg, config: dict, n_train: int, seed: int, device):
    """(FlatTarget, its net_state, the layout the reference reads) of the
    configuration, with the layout checked against the program's."""
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.models import create_backbone
    model, _, meta = create_backbone(cfg.backbone,
                                     num_classes=cfg.num_classes,
                                     **cfg.backbone_kw())
    tgt, _, net_state = make_flat_target(
        model, nd_size=n_train, num_classes=cfg.num_classes,
        rng=torch.Generator().manual_seed(derived_seed(seed, HOST_INIT)),
        has_batch_stats=meta["has_batch_stats"], device=device)
    lay = layout_mod.Layout(config)
    if (tgt.n_params, tgt.dim) != (lay.n_params, lay.dim):
        raise RuntimeError(
            f"{config['name']}: the program's flat vector has {tgt.n_params} "
            f"parameters in {tgt.dim}, the configuration's layout "
            f"{lay.n_params} in {lay.dim}")
    return tgt, net_state, lay


def runner(cfg, tgt, theta0, net_state):
    from bayesdll_tpu_torch.methods import get_runner_cls
    return get_runner_cls(cfg.method)(tgt, theta0, net_state, cfg)


def nested_stats(flat: dict) -> dict:
    """{"a/b": {"mean", "var"}} as the program's nested batch_stats."""
    out = {}
    for path, leaf in flat.items():
        node = out
        *outer, last = path.split("/")
        for name in outer:
            node = node.setdefault(name, {})
        node[last] = dict(leaf)
    return out
