"""Full-batch epochs (a train step and the val forward) completed in the
window, over the window's whole time, each block's host read included."""


def read(ctx):
    window = ctx.get("window")
    if not window or window["seconds"] <= 0.0:
        return None
    return window["epochs"] / window["seconds"]
