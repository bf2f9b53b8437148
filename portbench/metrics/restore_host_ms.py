"""restore_host_ms: the mean, over the window's failures whose detecting
tick restored requests (outside the profiled stretch), of that tick's
host reading of the checkpoint store: ``restore.read``
(``CheckpointStore.restore_request``) and ``restore.stack`` (the host
``torch.stack`` of the segments), in ms."""
from portbench import spans


def read(run):
    return spans.per_restoring_failure_ms(run, ["restore.read",
                                                "restore.stack"])
