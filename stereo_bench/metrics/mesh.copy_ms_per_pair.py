"""mesh.copy_ms_per_pair: the device seconds of the program's
``mesh.scatter`` (the pairs copied off the batch's card onto each
group's card) and ``mesh.gather`` (the results copied back into the
batch's result on the mesh's first card) spans, summed over the cards
they name, over the pairs its ``entry.request`` spans served, in ms;
nothing without a mesh."""

from stereo_bench import spans


def read(run):
    return spans.ms_per_pair("device_s", "mesh.scatter", "mesh.gather")
