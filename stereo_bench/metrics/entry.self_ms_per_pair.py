"""entry.self_ms_per_pair: the self seconds of the program's
``entry.request`` spans (host time inside a request that none of its
child spans covers: the entry's own Python, key and result work) over
the pairs they served, in ms."""

from stereo_bench import spans


def read(run):
    return spans.ms_per_pair("self_s", "entry.request")
