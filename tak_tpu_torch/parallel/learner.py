"""Data-parallel learner: one training step over the ranks (counterpart of
`tak_tpu/parallel/learner.py`).

Batch rows are split over the ranks (`place`), parameters are
replicated, BatchNorm takes the global batch statistics and the
gradients are summed over the ranks before Adam steps: the same math as
one process stepping on the whole batch.  `Network.train(mesh=)` runs
the same pieces over 500-example chunks, 20 to a step.
"""

from __future__ import annotations

import torch

from .mesh import all_reduce_grads, all_reduce_sum, replicate, shard_rows


class DPLearner:
    def __init__(self, network, mesh):
        self.network = network
        self.mesh = mesh

    def model(self, variables: dict):
        """The train-mode module holding `variables` (rank 0's, on every
        rank), its BatchNorms on the mesh."""
        return replicate(self.mesh,
                         self.network._train_model(variables, self.mesh))

    def init_opt_state(self, model):
        return self.network.make_optimizer(model.parameters())

    def place(self, planes, pi, z):
        """This rank's rows of a global batch, on its device."""
        dev = self.mesh.device
        return tuple(shard_rows(self.mesh, x).to(dev) for x in (planes, pi, z))

    def train_step(self, model, opt, planes, pi, z):
        """One step of `opt` on the global batch whose rows `place` gave
        this rank.  Returns the global (policy, value) loss parts."""
        loss, lp, lz = self.network._loss(model, planes, pi, z,
                                          self.mesh.world)
        loss.backward()
        all_reduce_grads(self.mesh, model.parameters())
        opt.step()
        opt.zero_grad()
        parts = all_reduce_sum(self.mesh, torch.stack([lp, lz]).detach())
        return tuple(parts.tolist())
