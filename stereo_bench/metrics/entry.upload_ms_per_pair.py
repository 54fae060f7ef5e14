"""entry.upload_ms_per_pair: the host seconds of the program's
``entry.upload`` spans (the copy of a request's host arrays to its card,
which holds the host while a pageable copy stages through CUDA)
over the pairs its ``entry.request`` spans served, in ms."""

from stereo_bench import spans


def read(run):
    return spans.ms_per_pair("host_s", "entry.upload")
