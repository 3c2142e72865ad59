"""The whole window's share of the card's fp32 peak: the model operations
of the work done in the window (the reference's count from the shapes: the
convolutions and deformable convolutions, with the backward's two products
where autograd runs them) over the window's time, over the data sheet's
fp32 rate."""


def read(run):
    layer, seconds = run["layer"], run["close"] - run["open"]
    if not layer.get("units") or seconds <= 0:
        return None
    return 100.0 * layer["unit_ops"] * layer["units"] / seconds / run["peaks"][1]
