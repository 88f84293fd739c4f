"""The out-of-core ``sort_task`` and ``join_task`` across 2 worker
processes, the port's against the JAX package's: the same specs
(``test_torch_process_data.SORT_SPECS`` and ``JOIN_SPECS``) run on the
port's 2-worker ``ProcessExecutor`` (CPU ranks) and on the JAX package's
own, whose workers run its Pallas kernel in interpret mode.  Every summary
(row count, key checksum, sortedness, the join's value sums, spill count)
must be equal, bit for bit.  A file of its own: the JAX workers' start-up
and interpret-mode kernels take most of its time.
"""
import repro.core as J
import repro_torch.core as T
from repro.dataframe import shuffle as jax_shuffle
from repro_torch.dataframe import shuffle
from test_torch_process_data import PARTS, run_all


def test_spanning_tasks_equal_jax_process_executor():
    with T.ProcessExecutor(n_workers=PARTS, devices_per_worker=2,
                           device="cpu") as ex:
        port = run_all(T, ex, shuffle, device="cpu")
    with J.ProcessExecutor(n_workers=PARTS, devices_per_worker=2,
                           build_comm=False) as ex:
        ref = run_all(J, ex, jax_shuffle)
    assert {n: t.result for n, t in port.items()} == \
        {n: t.result for n, t in ref.items()}
