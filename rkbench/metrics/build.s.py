"""build.s: the host clock around `ReverseKRanksEngine.build` (Algorithm
1: K2, and the pack at int8), ended by torch.cuda.synchronize(), in
set-up."""


def read(ctx):
    return ctx["build_s"]
