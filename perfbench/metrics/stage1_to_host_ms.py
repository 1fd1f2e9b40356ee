"""stage1_to_host_ms (ms): the mean card time (``device_us``, from a pair
of CUDA events) of the program's ``stage1.to_host`` spans, one per QoI
compressed: the copies of the coefficients and the mask to the host."""


def read(record: dict):
    us = [s["args"]["device_us"] for s in record.get("spans", [])
          if s["name"] == "stage1.to_host" and "device_us" in s.get("args", {})]
    return sum(us) / len(us) / 1e3 if us else None
