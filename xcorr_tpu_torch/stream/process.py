# Carried from xcorr_tpu/stream/process.py (see test_torch_host_copies).
r"""
:mod:`stream.process` -- Hashed preprocess-operations DSL
=========================================================

The declarative, sha256-verified per-channel preprocessing pipeline
(reference: ``xcorr/stream/process.py``): a `dict` mapping SEED channel
codes to lists of ``('operation', {parameters})`` tuples, hashed and
embedded in the dataset so the configuration travels with the data and is
*verified* on reload — config-as-data, preserved verbatim from the
reference design (SURVEY.md §5).

Two execution paths:

* **host** (:func:`process`): dispatch each op onto the obspy-lite
  Trace/Stream methods — used at the ingest edge and for irregular data.
* **device** (:mod:`xcorr_tpu.stream.compile`): the same op list compiled
  into one fused jitted function over dense ``(batch, n)`` blocks — the
  production TPU path.
"""

from __future__ import annotations

import json
import warnings

from ..util.hasher import hash_obj
from .trace import Stream, Trace

__all__ = ["help", "list_operations", "is_operation", "process",
           "example_process_dict", "hash_operations",
           "check_operations_hash", "operations_to_dict",
           "operations_to_json", "filter_operations",
           "apply_operation", "inject_dynamic_parameters"]

_self = "trace_method"


def _running_rms(waveforms, **params):
    from .running_rms import running_rms
    return running_rms(waveforms, **params)


# operation registry: method dispatch + dynamic parameter injection needs
# (mirror of the reference registry, xcorr/stream/process.py:29-94)
_operations = {
    "attach_response": {"method": _self, "inject": ["inventory"]},
    "decimate": {"method": _self, "inject": []},
    "detrend": {"method": _self, "inject": []},
    "filter": {"method": _self, "inject": []},
    "interpolate": {"method": _self, "inject": []},
    "merge": {"method": _self, "inject": []},
    "normalize": {"method": _self, "inject": []},
    "remove_response": {"method": _self, "inject": ["inventory"]},
    "remove_sensitivity": {"method": _self, "inject": ["inventory"]},
    "resample": {"method": _self, "inject": []},
    "rotate": {"method": _self, "inject": ["inventory"]},
    "select": {"method": _self, "inject": []},
    "simulate": {"method": _self, "inject": []},
    "taper": {"method": _self, "inject": []},
    "trim": {"method": _self, "inject": ["starttime", "endtime"]},
    "running_rms": {"method": _running_rms, "inject": []},
}


def list_operations():
    """Names of all implemented stream operations."""
    return list(_operations.keys())


def help(operation: str = None):
    """Print operation registry documentation."""
    ops = [operation] if operation else list(_operations)
    for op in ops:
        if op not in _operations:
            raise ValueError(f'Operation "{op}" not available.')
        print(f"Operation '{op}'")
        print(f"   injected args : {', '.join(_operations[op]['inject'])}")
        print()


def is_operation(operation: str):
    """Whether ``operation`` is in the registry."""
    return operation in _operations


def inject_dynamic_parameters(operation: str, parameters: dict,
                              inventory=None, starttime=None, endtime=None,
                              verb: int = 0):
    """Copy ``parameters`` and add the dynamic args the operation declares
    (inventory / trim times)."""
    from .trace import UTCDateTime
    params = parameters.copy()
    inject = _operations[operation]["inject"]
    if "inventory" in inject:
        params["inventory"] = inventory
    if "starttime" in inject and starttime is not None:
        params["starttime"] = UTCDateTime(starttime)
    if "endtime" in inject and endtime is not None:
        params["endtime"] = UTCDateTime(endtime)
    return params


def apply_operation(waveforms, operation: str, parameters: dict,
                    dynamic_parameters: dict = None,
                    raise_error: bool = False, stdout_prefix: str = "",
                    verb: int = 0):
    """Apply one operation in place; returns the (possibly new) waveforms
    or False on failure (reference ``xcorr/stream/process.py:199-297``,
    minus the ``eval`` dispatch — methods are looked up with getattr)."""
    if not isinstance(waveforms, (Trace, Stream)):
        msg = "``waveforms`` is not a Stream or Trace"
        if raise_error:
            raise TypeError(msg)
        warnings.warn(msg, UserWarning)
        return False
    if len(waveforms) == 0:
        msg = "``waveforms`` is empty."
        if raise_error:
            raise ValueError(msg)
        warnings.warn(msg, UserWarning)
        return False

    if is_operation(operation):
        method = _operations[operation]["method"]
        params = inject_dynamic_parameters(
            operation, parameters, **dynamic_parameters
        ) if dynamic_parameters else parameters
    elif callable(operation):
        method, params = operation, parameters
    else:
        msg = f'"{operation}" is not an implemented operation or callable.'
        if raise_error:
            raise NotImplementedError(msg)
        warnings.warn(msg, UserWarning)
        return False

    if verb > 0:
        print(f"{stdout_prefix}{operation} :", params)
    try:
        if method == _self:
            waveforms = getattr(waveforms, operation)(**params)
        else:
            waveforms = method(waveforms, **params)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as error:
        msg = f'Failed to execute operation "{operation}". Error: {error}'
        if raise_error:
            raise RuntimeError(msg)
        warnings.warn(msg, UserWarning)
        return False
    if verb > 3:
        print(waveforms)
    return waveforms


def process(waveforms, operations: list, inventory=None, starttime=None,
            endtime=None, raise_error: bool = False, verb: int = 0, **kw):
    """Run an operation list over waveforms (host path)."""
    if not isinstance(waveforms, (Trace, Stream)):
        raise TypeError("``waveforms`` is not a Stream or Trace")
    if not isinstance(raise_error, bool):
        raise TypeError("``raise_error`` is not of type `bool`")

    dyn_params = {"inventory": inventory, "starttime": starttime,
                  "endtime": endtime}
    if verb > 0:
        print("Apply processing operations:")

    for operation_params in operations:
        if (not isinstance(operation_params, (tuple, list))
                or len(operation_params) != 2):
            msg = ("Provided operation should be a tuple or list with "
                   "length 2 (method:str,params:dict).")
            if raise_error:
                raise TypeError(msg)
            warnings.warn(msg, UserWarning)
            continue
        operation, parameters = operation_params
        if not (is_operation(operation) or callable(operation)):
            msg = f'Provided operation "{operation}" is invalid thus ignored.'
            if raise_error:
                raise ValueError(msg)
            warnings.warn(msg, UserWarning)
            continue
        try:
            waveforms = apply_operation(
                waveforms=waveforms, operation=operation,
                parameters=parameters, dynamic_parameters=dyn_params,
                raise_error=raise_error, verb=verb, stdout_prefix=" * ",
            )
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as error:
            msg = f'Failed to execute operation "{operation}". Error: {error}'
            if raise_error:
                raise RuntimeError(msg)
            warnings.warn(msg, UserWarning)
            return None
        if waveforms is False:
            return None
    return waveforms


def example_process_dict(to_json: bool = False):
    """Example per-channel operations dict: the canonical BHZ/BHR/EDH
    production chains (reference ``xcorr/stream/process.py:415-537``)."""
    operations = {
        "BHZ": [
            ("merge", {"method": 1, "fill_value": "interpolate",
                       "interpolation_samples": 0}),
            ("filter", {"type": "highpass", "freq": .05}),
            ("detrend", {"type": "demean"}),
            ("remove_response", {"output": "VEL"}),
            ("filter", {"type": "highpass", "freq": 3.}),
            ("interpolate", {"sampling_rate": 50, "method": "lanczos",
                             "a": 20}),
            ("filter", {"type": "lowpass", "freq": 20.}),
            ("trim", {}),
            ("detrend", {"type": "demean"}),
            ("taper", {"type": "cosine", "max_percentage": 0.05,
                       "max_length": 30.}),
        ],
        "BHR": [
            ("merge", {"method": 1, "fill_value": "interpolate",
                       "interpolation_samples": 0}),
            ("filter", {"type": "highpass", "freq": .05}),
            ("detrend", {"type": "demean"}),
            ("remove_response", {"output": "VEL"}),
            ("rotate", {"method": "->ZNE"}),
            ("rotate", {"method": "NE->RT", "back_azimuth": 250.30}),
            ("select", {"channel": "BHR"}),
            ("filter", {"type": "highpass", "freq": 3.}),
            ("interpolate", {"sampling_rate": 50, "method": "lanczos",
                             "a": 20}),
            ("filter", {"type": "lowpass", "freq": 20.}),
            ("trim", {}),
            ("detrend", {"type": "demean"}),
            ("taper", {"type": "cosine", "max_percentage": 0.05,
                       "max_length": 30.}),
        ],
        "EDH": [
            ("merge", {"method": 1, "fill_value": "interpolate",
                       "interpolation_samples": 0}),
            ("detrend", {"type": "demean"}),
            ("remove_sensitivity", {}),
            ("filter", {"type": "bandpass", "freqmin": 3., "freqmax": 20.}),
            ("decimate", {"factor": 5}),
            ("trim", {}),
            ("detrend", {"type": "demean"}),
            ("taper", {"type": "cosine", "max_percentage": 0.05,
                       "max_length": 30.}),
        ],
    }
    return json.dumps(operations) if to_json else operations


_channel_band_codes = "FGDCESHBMLVURPTQ"


def filter_operations(operations: dict):
    """Keep only keys that are 3-character channel codes starting with a
    known SEED band code."""
    channels = [chan for chan in operations.keys()
                if len(chan) == 3 and chan[0] in _channel_band_codes]
    return {chan: operations[chan] for chan in channels}


def hash_operations(operations: dict):
    """Filter to channel keys and embed the sha256 hash."""
    operations = filter_operations(operations)
    operations["sha256_hash"] = hash_obj(operations)
    return operations


def check_operations_hash(operations: dict, raise_error: bool = False):
    """Verify the embedded sha256 against the recomputed one."""
    if "sha256_hash" not in operations:
        raise ValueError("Preprocess operations does not contain a hash!")
    sha256 = hash_obj(filter_operations(operations))
    if raise_error and operations["sha256_hash"] != sha256:
        raise ValueError(
            f"Preprocess operations hash '{sha256}' does not match the "
            f"computed hash '{operations['sha256_hash']}'!")
    return operations["sha256_hash"] == sha256


def operations_to_dict(operations: str):
    """Load (and hash-verify) an operations dict from its JSON attr form."""
    operations = json.loads(operations)
    if "sha256_hash" not in operations:
        raise ValueError("Preprocess operations does not contain a hash!")
    sha256 = operations["sha256_hash"]
    operations = hash_operations(operations)
    if operations["sha256_hash"] != sha256:
        raise ValueError(
            f"Preprocess operations hash '{operations['sha256_hash']}' does "
            f"not match the loaded hash '{sha256}'!")
    return operations


def operations_to_json(operations: dict):
    """Dump an operations dict to its hashed JSON attr form."""
    return json.dumps(hash_operations(operations))
