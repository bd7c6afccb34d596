"""Public serving API of the port (counterpart of ``repro/serve/__init__.py``).

The error-kind taxonomy every ``RequestRecord.error_kind`` draws from is
:class:`~repro_torch.serve.lifecycle.ErrorKind`, with
:data:`~repro_torch.serve.lifecycle.RETRYABLE_KINDS` marking the kinds the
engine retries before failing a request.  Crash safety lives in
:mod:`repro_torch.serve.journal` (the write-ahead request journal) plus
``ServeEngine.snapshot`` / ``ServeEngine.restore``; the ``process_crash``
fault kind (:class:`~repro_torch.serve.faults.SimulatedCrash`) drives the
recovery harness of ``repro_torch.launch.serve``.

``ServeEngine`` and ``PagesExhausted`` load on first use: the engine
imports the model, whose attention imports ``serve.kvquant``, so an eager
import here would make importing the model import itself.
"""

from repro_torch.serve.faults import (FaultInjector, FaultSpec, InjectedFault,
                                      SimulatedCrash)
from repro_torch.serve.journal import (Collated, JournalCorruption,
                                       JournalError, JournalReplay,
                                       JournalWriter, collate, read_journal)
from repro_torch.serve.kvquant import (KV_DTYPES, KVSpec, dequantize_kv,
                                       quantize_kv)
from repro_torch.serve.lifecycle import (ErrorKind, IllegalTransition, Request,
                                         RequestRecord, RequestState,
                                         RETRYABLE_KINDS)
from repro_torch.serve.paging import NULL_PAGE, PageAllocator
from repro_torch.serve.sampling import NonFiniteLogitsError, sample_token


def __getattr__(name):
    if name in ("PagesExhausted", "ServeEngine"):
        from repro_torch.serve import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
