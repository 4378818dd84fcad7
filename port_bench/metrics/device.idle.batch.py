"""The card's idle share of the traced window of batch transcription: 1 -
the union of every device operation's interval over the window."""

from port_bench import harness

UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "transcribe_audio_s_per_s"


def read(run):
    return harness.idle_percent(run)
