"""entry.copy_ms_per_pair: the device seconds of the program's
``graph.load`` (the copy-in and cast of a request's images into a CUDA
graph's static inputs) and ``graph.clone`` (the clones of its outputs)
spans, summed over the cards they name, over the pairs its
``entry.request`` spans served, in ms."""

from stereo_bench import spans


def read(run):
    return spans.ms_per_pair("device_s", "graph.load", "graph.clone")
