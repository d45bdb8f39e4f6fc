"""kernels.parse_device_s: device seconds of a job's parse kernels
(``parse_events`` / ``parse_events_big``), the sum of its ``dev.kernel``
spans, the mean over the window's jobs."""

from benchmark import spans


def read(run):
    return spans.mean_per_job(run, "dev.kernel")
