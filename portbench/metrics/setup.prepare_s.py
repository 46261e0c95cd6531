"""Host seconds of engine.prepare (scene load, validation, camera, the
intersection backend's tree), a span around the call in the benchmark."""


def read(ctx):
    return ctx["spans"].get("prepare")
