"""One module a kind of traffic, named by a traffic file's ``kind``.  Its
``Session(cell)`` makes the inputs from the seed and sets the program up
(``__init__``, the set-up), then offers ``window(seconds)``, the measured
closed loop; ``traced(tw)``, a few steps under the profiler;
``release()``, which frees the program's state; and ``check(p)``, the
numbers compared with the reference (``p`` its precision)."""
