"""The stereo step's share of its roofline (%): the least time its calls'
inputs need (portbench/rooflines/stereo.py) over the device time of the
events those calls launched (the device trace's events that start inside
each process's `frontend.stereo` spans)."""


def read(trace):
    least = trace.get("works", {}).get("stereo", [])
    device_s = trace.get("device_s", {}).get("frontend.stereo")
    if not least or not device_s:
        return None
    return 100.0 * sum(w[0] for w in least) / device_s
