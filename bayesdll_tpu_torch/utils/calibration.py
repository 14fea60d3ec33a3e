"""Calibration metrics: ECE, MCE, NLL, temperature scaling (counterpart of
bayesdll_tpu.utils.calibration).

Definitions, as the reference's `calibration.py`:
  * binning is over ALL (example, class) pairs, probabilities and one-hot
    labels flattened to length N*K;
  * bins are the right edges linspace(0, 1+1e-8, M+1)[1:], a value's bin is
    the first edge above it;
  * ECE = sum_b |acc_b - conf_b| * n_b / N;  MCE = max_b |acc_b - conf_b|;
  * NLL = mean(logsumexp(logits/T) - (logits/T)[y]).
The metric math runs in fp32 torch on the CPU (the runners gather logits
as numpy); the temperature fit runs in float64 scipy.  matplotlib is
imported only inside the plotting code, and only when a plot path is given;
`can_plot` says whether it is there.
"""

from __future__ import annotations

import importlib.util
from typing import Optional, Tuple

import numpy as np
import scipy.optimize
import scipy.special
import torch


def can_plot() -> bool:
    """Whether matplotlib is installed (the machine with the card has none)."""
    return importlib.util.find_spec("matplotlib") is not None


def _as_tensors(labels, logits):
    return (torch.as_tensor(np.asarray(labels)).long(),
            torch.as_tensor(np.asarray(logits), dtype=torch.float32))


def calc_bins(labels, logits, num_bins: int, temperature: float = 1.0):
    """Confidence binning: (bins, bin_accs, bin_confs, bin_sizes) tensors."""
    labels, logits = _as_tensors(labels, logits)
    k = logits.shape[1]
    labels_oneh = torch.nn.functional.one_hot(labels, k).to(torch.float32).reshape(-1)
    preds = torch.softmax(logits / temperature, dim=1).reshape(-1)

    bins = torch.linspace(0.0, 1.0 + 1e-8, num_bins + 1,
                          dtype=torch.float32)[1:]
    binned = torch.bucketize(preds, bins, right=True).clamp(0, num_bins - 1)

    def bin_sum(w):
        return torch.zeros(num_bins).index_add_(0, binned, w)

    bin_sizes = bin_sum(torch.ones_like(preds))
    denom = torch.clamp(bin_sizes, min=1.0)
    nonzero = bin_sizes > 0
    bin_accs = torch.where(nonzero, bin_sum(labels_oneh) / denom, 0.0)
    bin_confs = torch.where(nonzero, bin_sum(preds) / denom, 0.0)
    return bins, bin_accs, bin_confs, bin_sizes


def nll_from_logits(labels, logits, temperature: float = 1.0) -> torch.Tensor:
    labels, logits = _as_tensors(labels, logits)
    z = logits / temperature
    picked = z.gather(1, labels[:, None])[:, 0]
    return torch.mean(torch.logsumexp(z, dim=1) - picked)


def compute_metrics(labels, logits, num_bins: int = 15,
                    temperature: float = 1.0):
    """(ece, mce, nll) as python floats."""
    return analyze(labels, logits, num_bins=num_bins, temperature=temperature)


def analyze(labels, logits, num_bins: int = 15,
            plot_save_path: Optional[str] = None, temperature: float = 1.0):
    """ECE/MCE/NLL and an optional reliability plot."""
    bins, bin_accs, bin_confs, bin_sizes = calc_bins(
        labels, logits, num_bins, temperature)
    gap = torch.abs(bin_accs - bin_confs)
    ece = float(torch.sum(gap * bin_sizes / torch.sum(bin_sizes)))
    mce = float(torch.max(gap))
    nll = float(nll_from_logits(labels, logits, temperature))
    if plot_save_path is not None:
        draw_reliability_plot(
            bins.numpy(), bin_accs.numpy(), plot_save_path,
            title=f"Temperature = {temperature}", ece=ece, mce=mce, nll=nll)
    return ece, mce, nll


def find_optimal_temperature(labels, logits,
                             plot_save_path: Optional[str] = None,
                             max_iter: int = 10000) -> Tuple[float, bool]:
    """Fit T minimising the NLL of `logits / T` (scipy, on the host).
    Returns (Topt, success)."""
    labels = np.asarray(labels)
    logits = np.asarray(logits, np.float64)

    def fun(t):
        z = logits / t
        return float(np.mean(
            scipy.special.logsumexp(z, axis=1) - z[np.arange(len(labels)), labels]))

    temps, losses = [], []

    def callback(x):
        temps.append(float(np.ravel(x)[0]))
        losses.append(fun(x))

    result = scipy.optimize.minimize(
        fun, np.ones(1), options={"maxiter": max_iter}, callback=callback)
    topt = float(np.ravel(result.x)[0]) if result.x is not None else 1.0

    if plot_save_path is not None and temps:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.figure(figsize=(10, 4))
        plt.subplot(121)
        plt.plot(range(len(temps)), temps)
        plt.title("Temperature T"); plt.xlabel("Iterations")
        plt.subplot(122)
        plt.plot(range(len(losses)), losses)
        plt.title("NLL on validation set"); plt.xlabel("Iterations")
        plt.savefig(plot_save_path, bbox_inches="tight")
        plt.close()
    return topt, bool(result.success)


def draw_reliability_plot(bins, bin_accs, fig_name, title=None,
                          ece=None, mce=None, nll=None):
    """Reliability diagram."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt

    bins = np.asarray(bins)
    bin_accs = np.asarray(bin_accs)
    bin_centers = (np.insert(bins, 0, 0)[:-1] + bins) / 2
    width = bin_centers[1] - bin_centers[0] if len(bin_centers) > 1 else 1.0

    fig = plt.figure(figsize=(8, 8))
    ax = fig.gca()
    ax.set_xlim(0, 1 + 1e-8); ax.set_ylim(0, 1)
    plt.xlabel("Confidence"); plt.ylabel("Accuracy")
    ax.set_axisbelow(True)
    ax.grid(color="gray", linestyle="dashed")
    plt.bar(bin_centers, bin_centers, width=width, alpha=0.3,
            edgecolor="black", color="r", hatch="\\")
    plt.bar(bin_centers, bin_accs, width=width, alpha=0.3,
            edgecolor="black", color="b")
    plt.plot([0, 1], [0, 1], "--", color="gray", linewidth=2)
    ax.set_aspect("equal", adjustable="box")
    handles = []
    if ece is not None:
        handles.append(mpatches.Patch(color="green", label=f"ECE = {ece*100:.2f}%"))
    if mce is not None:
        handles.append(mpatches.Patch(color="red", label=f"MCE = {mce*100:.2f}%"))
    if nll is not None:
        handles.append(mpatches.Patch(color="blue", label=f"NLL = {nll:.4f}"))
    if handles:
        plt.legend(handles=handles, loc="lower right")
    if title:
        plt.title(title)
    plt.savefig(fig_name, bbox_inches="tight")
    plt.close()
