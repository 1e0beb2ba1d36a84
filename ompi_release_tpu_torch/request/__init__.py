"""Request/completion engine — the ``ompi/request`` analogue."""

from .request import (  # noqa: F401
    Request, GeneralizedRequest, Status, RequestState, from_future,
    test, test_all, test_any, wait, wait_all, wait_any, wait_some,
)
