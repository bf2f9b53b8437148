"""restored_mib: the mean, over the failures whose detecting tick
restored requests, of the checkpoint bytes that tick restored
(``CheckpointStore.stats.bytes_restored``), in MiB."""


def read(run):
    got = [f.restored_bytes for f in run.failures if f.restored_bytes > 0]
    return sum(got) / len(got) / 2 ** 20 if got else None
