"""The plain reference the benchmark judges the program's answers by: SQM2
and the rfo_fsb step in plain PyTorch. Nothing here imports the program."""
