"""kernels.launches_per_pair: the port's kernel-wrapper launches over the
window's requests (ops.cuda._build.launch_counts(); a CUDA graph's
replay counts its capture's launches), over the pairs served."""


def read(run):
    if not run.pairs or not run.launches:
        return None
    return run.launches / run.pairs
