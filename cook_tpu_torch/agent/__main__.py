from cook_tpu_torch.agent.daemon import main

main()
