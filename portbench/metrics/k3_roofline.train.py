"""The panel-cotangent kernel K3's share of its roofline over a training
window, in %: its output type is f32 with edge-space cotangents, else the
panels' type."""

from portbench.harness.readers import block_share, training_panel_bytes


def read(run):
    edge = run.config["inference"]["solve_cotangent"] == "edge"
    return block_share(run, "k3", 4 if edge else training_panel_bytes(run.config))
