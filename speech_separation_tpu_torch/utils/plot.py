"""Training plots (a copy of speech_separation_tpu/utils/plot.py, after the
reference's tools/plot.py): spectrogram heatmaps and loss curves, written as
PNGs into the experiment directory under the reference's file names
(Mixture.png, Masked_Mixture.png, Chosen_Permutation.png,
Loss_NNN-MMM.png, ...). matplotlib, with the Agg backend, is imported only
when a plot is drawn: the port's other modules never import it, and a
machine without it trains without plots (``available``).
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np


def available() -> bool:
    """Whether matplotlib is installed (without importing it)."""
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_spec(array: np.ndarray, path: str) -> None:
    """Spectrogram heatmap of a (time, freq) array (reference plot.py:15-34)."""
    plt = _plt()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    plt.imshow(np.flipud(np.asarray(array).T))
    plt.tick_params(which="both", bottom=False, left=False, labelbottom=False,
                    labelleft=False)
    plt.colorbar(aspect=40, pad=0.025).ax.tick_params(labelsize="small")
    plt.xlabel("time")
    plt.ylabel("frequency")
    plt.title(os.path.basename(path).split(".")[0].replace("_", " "))
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.clf()
    plt.cla()


def plot_loss(train_curve, cv_curve, path: str) -> None:
    """Loss curves, each ([epochs], [losses]) (reference plot.py:38-73)."""
    plt = _plt()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    labels = ["train"]
    plt.plot(train_curve[0], train_curve[1])
    if cv_curve and len(cv_curve[0]):
        plt.plot(cv_curve[0], cv_curve[1])
        labels.append("cv")
    plt.legend(labels)
    plt.title(os.path.basename(path).split(".")[0].replace("_", " "))
    plt.xlabel("epoch")
    plt.ylabel("avg sample loss")
    plt.tick_params(labelsize="x-small", direction="in")
    plt.savefig(path, dpi=150, bbox_inches="tight")
    plt.clf()
    plt.cla()
