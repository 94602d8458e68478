"""Constants the port shares with the control plane, as its own copies.

The port imports nothing of :mod:`gpumounter_tpu`; where a value is part
of a contract between the two (a deadline both sides judge by, a format
tag both packages read), it is copied here and must stay equal to the
control plane's.
"""

# How long a re-federation barrier may sit incomplete before the control
# plane surfaces it as STUCK (``gpumounter_tpu/utils/consts.py``,
# ``DEFAULT_RESIZE_BARRIER_TIMEOUT_S``). Members poll with the same
# deadline, so the two sides never desynchronise.
DEFAULT_RESIZE_BARRIER_TIMEOUT_S = 120.0

# The sharded checkpoint's format tag (``jaxcheck/drain.py``,
# ``SHARDED_FORMAT``): a root written by either package names the same
# format, so each package's checks accept the other's commits.
SHARDED_FORMAT = "tpumounter-sharded-v1"
