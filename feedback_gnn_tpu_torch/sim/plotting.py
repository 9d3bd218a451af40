"""LER curve store and log-log plotting, as ``feedback_gnn_tpu/sim/plotting.py``:
named curves, ``simulate`` wraps the MC harness and appends its results.
Matplotlib is imported by ``plot`` only, so a headless simulation never
needs it."""

from __future__ import annotations

import numpy as np

from .montecarlo import sim_ler

__all__ = ["PlotLER"]


class PlotLER:
    def __init__(self, title="Logical Error Rate"):
        self.title = title
        self._ps = []
        self._rates = []
        self._legends = []
        self._is_ler = []

    def add(self, ps, rates, legend="", is_ler=True):
        self._ps.append(np.asarray(ps))
        self._rates.append(np.asarray(rates))
        self._legends.append(legend)
        self._is_ler.append(is_ler)

    def remove(self, idx=-1):
        for lst in (self._ps, self._rates, self._legends, self._is_ler):
            del lst[idx]

    def reset(self):
        self.__init__(self.title)

    def simulate(
        self,
        step_fn,
        ps,
        batch_size,
        max_mc_iter,
        num_target_block_errors=100,
        legend="",
        add_ler=True,
        add_flagged=False,
        early_stop=True,
        seed=0,
        verbose=True,
        show_fig=False,
        checkpoint_path=None,
        write_checkpoint=True,
        fold_process_key=True,
        device=None,
    ):
        """Run the MC sweep (``sim_ler``) and store the resulting curve(s).
        Returns the SimResult."""
        result = sim_ler(
            step_fn,
            ps,
            batch_size=batch_size,
            max_mc_iter=max_mc_iter,
            num_target_block_errors=num_target_block_errors,
            early_stop=early_stop,
            seed=seed,
            verbose=verbose,
            checkpoint_path=checkpoint_path,
            write_checkpoint=write_checkpoint,
            fold_process_key=fold_process_key,
            device=device,
        )
        if add_flagged:
            self.add(ps, result.flagged_rate, legend + " (flagged)", is_ler=False)
        if add_ler:
            self.add(ps, result.ler, legend, is_ler=True)
        if show_fig:
            self.plot()
        return result

    def plot(self, save_path=None, ylim=None):
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 6))
        for ps, rates, legend, is_ler in zip(self._ps, self._rates, self._legends, self._is_ler):
            mask = rates > 0
            style = "-o" if is_ler else "--s"
            ax.loglog(ps[mask], rates[mask], style, label=legend)
        ax.set_xlabel("physical error rate p")
        ax.set_ylabel("logical error rate")
        ax.set_title(self.title)
        ax.grid(True, which="both", alpha=0.3)
        if ylim:
            ax.set_ylim(ylim)
        if self._legends and any(self._legends):
            ax.legend()
        if save_path:
            fig.savefig(save_path, bbox_inches="tight", dpi=120)
        return fig, ax
