"""The port's cost model: ``StepCost`` counts a step's FLOPs, bytes,
collectives and peak memory against an H100's peaks (``analysis``);
``report`` renders a dry run's records (``launch.dryrun``)."""
