"""index.gb: the engine's query-path storage, `engine.memory_bytes()`
after the build, in 1e9 bytes."""


def read(ctx):
    return ctx["index_bytes"] / 1e9
