"""Running queued jobs with progress rows: ``ExecProgressQueue``.

The port of the reference's ``audiotools_tpu/parallel/queue.py``, with
its API: ``execute(function, progress_text, completion_output, *args,
**kwargs)`` queues ``function(*args, progress=..., **kwargs)``, and
``run(max_processes)`` runs the queue and returns the results in queue
order, a progress row a job with a ``progress_text`` (drawn by
``utils.messenger``'s display) and each job's ``completion_output`` (a
string, or a callable of the result) printed as it ends.  One process,
or one job, runs the queue in the calling thread, as the reference's
serial path does.

More run in the transcode farm's worker threads (``parallel.farm
.run_jobs``), never in forked processes, where the reference forks one
a job: a child forked after the parent made a CUDA context cannot use
the card.  A job that raises stops the queue (no job starts after it)
and its exception is raised again in the caller, the first failed job's
in queue order, as the reference raises its child's exception.  Where a
job runs is its own arguments' business: the threads take no device of
their own (``run_jobs`` over ``["cpu"]``).
"""

from __future__ import annotations


class ExecQueueError(Exception):
    """a queued job failed; the reference raises it when the child's
    exception cannot be sent back, which a thread's always can"""


class ExecProgressQueue:
    """runs one function a queued job, in order or in threads"""

    def __init__(self, progress_display):
        self.progress_display = progress_display
        self.queued_jobs = []

    def execute(self, function, progress_text=None,
                completion_output=None, *args, **kwargs):
        """queues ``function(*args, progress=fn, **kwargs)``;
        ``progress_text`` labels its row while it runs, and
        ``completion_output`` (a string, or a callable of the result) is
        printed when it ends"""
        self.queued_jobs.append((progress_text, completion_output,
                                 function, args, kwargs))

    def run(self, max_processes=1):
        """runs every queued job; returns their results in queue order"""
        if max_processes <= 1 or len(self.queued_jobs) <= 1:
            return self.__run_serial__()
        return self.__run_parallel__(max_processes)

    def __run_serial__(self):
        results = []
        for (progress_text, completion_output, function, args,
             kwargs) in self.queued_jobs:
            if progress_text is not None:
                row = self.progress_display.add_row(progress_text)
                progress = row.update
            else:
                row = None
                progress = None
            try:
                result = function(*args, progress=progress, **kwargs)
            finally:
                if row is not None:
                    row.finish()
            self.__display_completion__(completion_output, result)
            results.append(result)
        self.queued_jobs = []
        return results

    def __run_parallel__(self, max_processes):
        from .farm import run_jobs

        jobs = self.queued_jobs
        self.queued_jobs = []
        rows = all(job[0] is not None for job in jobs)

        def run(job, _device, progress=_no_progress):
            (_text, _completion, function, args, kwargs) = job
            return function(*args, progress=progress, **kwargs)

        def done(index, result, error):
            if error is None:
                self.__display_completion__(jobs[index][1], result)

        outcomes = run_jobs(jobs, run, workers=max_processes,
                            devices=["cpu"], done=done,
                            stop_on_error=True,
                            display=self.progress_display if rows else None,
                            label=lambda job: job[0])
        for (_result, error) in outcomes:
            if error is not None:
                raise error
        return [result for (result, _error) in outcomes]

    def __display_completion__(self, completion_output, result):
        if completion_output is None:
            return
        if callable(completion_output):
            output = completion_output(result)
        else:
            output = completion_output
        if output is not None:
            self.progress_display.output_line(str(output))


def _no_progress(_current, _total):
    pass
