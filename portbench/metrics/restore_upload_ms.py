"""restore_upload_ms: the mean, over the window's failures whose
detecting tick restored requests (outside the profiled stretch), of that
tick's ``restore.upload`` host spans: the restored segments' copies to
the card, in ms."""
from portbench import spans


def read(run):
    return spans.per_restoring_failure_ms(run, ["restore.upload"])
