from wc_path_tracer_tpu_torch.cli import main

main()
