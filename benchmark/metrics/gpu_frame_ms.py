"""The card's time a frame, as an engine's GPU frame statistic shows it:
each window frame from a mark recorded just before its frame graph's
replay to its completion mark, averaged over the window's frames. The
card reaches the first mark once the replay is launched and the frames
before it are done, so the host's pace, which sets the draw loop's frame
time where the host frame state is the slower side, does not count."""

KIND = "end_to_end"
UNIT = "ms"


def read(run):
    ms = run.window.device_ms
    return None if not ms else sum(ms) / len(ms)
