"""Plots and CSV reports: energy profiles, NEB bands, reaction ladders.

Counterpart of `multioptpy_tpu/analysis/visualization.py`. matplotlib is
optional and imported only when a plot is drawn (`_plt`): where it is not
installed, a plot raises the ImportError that names it, after the CSV it
was asked for is written.
"""

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_energy_profile(energies, path_png, title="energy profile",
                        ylabel="E (Hartree)", csv_path=None):
    """Optimization, IRC or scan energy curve."""
    e = np.asarray(energies)
    if csv_path:
        np.savetxt(csv_path, e, header=ylabel)
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(np.arange(len(e)), e, "o-", ms=3)
    ax.set_xlabel("step")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path_png, dpi=150)
    plt.close(fig)
    return path_png


def plot_neb_band(energy_history, path_png, csv_path=None):
    """All NEB iterations' band profiles, the final one highlighted."""
    hist = np.asarray(energy_history)
    if hist.ndim == 1:
        hist = hist[None, :]
    if csv_path:
        np.savetxt(csv_path, hist[-1], header="energy_hartree")
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, band in enumerate(hist[:-1]):
        ax.plot(band - hist[0][0], color="grey", alpha=0.25, lw=0.8)
    ax.plot(hist[-1] - hist[0][0], "o-", color="crimson", label="final")
    ax.set_xlabel("image")
    ax.set_ylabel("E - E$_0$ (Hartree)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path_png, dpi=150)
    plt.close(fig)
    return path_png


def plot_reaction_profile(energies, labels, path_png):
    """Stationary-point ladder diagram (reactant, TS, product) in
    kcal/mol relative to the first."""
    e = np.asarray(energies)
    rel = (e - e[0]) * 627.509  # kcal/mol
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    xs = np.arange(len(e))
    for x, y, lab in zip(xs, rel, labels):
        ax.hlines(y, x - 0.3, x + 0.3, lw=3)
        ax.annotate(f"{lab}\n{y:.1f}", (x, y), textcoords="offset points",
                    xytext=(0, 8), ha="center", fontsize=8)
    for i in range(len(e) - 1):
        ax.plot([xs[i] + 0.3, xs[i + 1] - 0.3], [rel[i], rel[i + 1]],
                "k--", lw=0.8)
    ax.set_ylabel("relative E (kcal/mol)")
    ax.set_xticks([])
    fig.tight_layout()
    fig.savefig(path_png, dpi=150)
    plt.close(fig)
    return path_png
