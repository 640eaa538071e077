"""Host seconds of the traced track's fixed costs: the fold datas' build
and upload, the warm-up epoch, the graph capture and the gated checkpoint
saves (the program's ``audio_clf/plan``, ``foldrun/warm_epoch``,
``foldrun/capture`` and ``audio_clf/save`` records of the track that
holds the traced window; they lie outside the profiled slice)."""

from portbench.harness import program

UNIT = "s/track"


def read(ctx):
    return program.track_fixed_s(ctx, "train")
