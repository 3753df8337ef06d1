"""Task-axis data parallelism for the meta step.

Counterpart of gmeta_tpu/parallel/dp.py. There, the meta-batch's leading
task axis is sharded over the mesh's 'task' axis with the parameters
replicated, and XLA inserts the meta-gradient psum. Here each rank takes
its own contiguous slice of the task axis (`local_tasks`: rank t of the
task axis holds tasks [t*T/N, (t+1)*T/N), the block JAX's P("task") gives
device t), and the learner sums the gradients over the task group as one
flat buffer (`collectives.all_reduce_flat`), see meta/maml.py.
"""

from __future__ import annotations


def local_tasks(n_tasks: int, n_groups: int, index: int) -> slice:
    """The contiguous slice of `n_tasks` tasks that group `index` of
    `n_groups` holds; the tasks must divide evenly."""
    if n_tasks % n_groups:
        raise ValueError(f"{n_tasks} tasks do not split evenly over "
                         f"{n_groups} task groups")
    n = n_tasks // n_groups
    return slice(index * n, (index + 1) * n)
