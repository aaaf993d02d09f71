"""The plain float32 references that decide a run's ``correct``, one a
model family (``reference/<family>.py``, found by ``family.py``). The
family-neutral helpers of ``sd.py`` (``token_ids``, ``initial_noise``,
``Net``, ``fp8_quant``) are there for another family's reference to
import."""
