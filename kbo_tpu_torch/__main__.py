from kbo_tpu_torch.cli import main

main()
