"""The reference's import path ``inaSpeechSegmenter.thread_returning``
(thread_returning.py:11-25): a Thread whose ``join()`` returns the
target's result, for user code written against the reference."""

from threading import Thread

__all__ = ["ThreadReturning"]


class ThreadReturning(Thread):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._result = None

    def run(self):
        if self._target is not None:
            self._result = self._target(*self._args, **self._kwargs)

    def join(self, *args):
        super().join(*args)
        return self._result
