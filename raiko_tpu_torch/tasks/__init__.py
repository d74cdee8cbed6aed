"""Task management: status state machine + persistence backends
(reference tasks/ crate)."""

from .manager import (  # noqa: F401
    TaskDescriptor,
    TaskManager,
    TaskStatus,
    get_task_manager,
)
