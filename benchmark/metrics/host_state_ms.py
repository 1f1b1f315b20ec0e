"""Host frame state: the mean host milliseconds of a call of
Renderer.frame_bundle (the ECS gather, draw parameters, lights and the
blob pack) in the window of a traced run."""

KIND = "per_layer"
UNIT = "ms/frame"


def read(run):
    return run.spans.mean_ms("host_state")
