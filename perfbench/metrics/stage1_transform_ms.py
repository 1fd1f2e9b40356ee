"""stage1_transform_ms (ms): the mean card time (``device_us``, from a
pair of CUDA events) of the program's ``stage1.transform`` spans, one per
QoI compressed: the forward wavelet kernel and the threshold's mask."""


def read(record: dict):
    us = [s["args"]["device_us"] for s in record.get("spans", [])
          if s["name"] == "stage1.transform" and "device_us" in s.get("args", {})]
    return sum(us) / len(us) / 1e3 if us else None
