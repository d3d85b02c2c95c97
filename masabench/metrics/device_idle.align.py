"""Device, full alignments: the share of the pairs' time with no operation on
the device (%)."""

from masabench.readings import device_idle

read = device_idle
