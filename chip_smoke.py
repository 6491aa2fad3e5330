#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

Run from the repository root:  python3 chip_smoke.py [--parent TREE]
(``--fleet`` runs phases 1, 4, 16, 17 and 18 alone, ``--nn`` phases 1,
7 and 20 alone, ``--bert`` phases 1 and 21 alone, ``--vision`` phases 1
and 22 alone, ``--rnn`` phases 1 and 23 alone, ``--static`` phases 1, 24
and 25 alone, ``--deploy`` phases 1 and 26 alone, ``--lazy`` phases 1 and
27 alone, ``--dist`` phases 1, 28 and 29 alone, ``--fluid`` phases 1
and 30 alone, ``--incubate`` phases 1 and 31 alone; none prints the
kernels line)

Every phase runs under the default FLAGS_lazy_eager (True): the Paddle
surface's eager steps are deferred into graphs (paddle_tpu_torch/core/
lazy.py) that run at a host read or at clear_grad(), on the card as one
CUDA graph a step from its third. Where a phase means the immediate path
it sets the flag False and says so: 20c's host time an op, 22b (its
profile times the forward, backward and update apart) and phase 24's
eager runs. Where a phase counts a step's launches before any host
read it runs the pending graph first (lazy.flush(), the executor's step
boundary), and a phase that swaps a function for one step runs the step's
graph before it swaps it back.

Phases, one line each:
  1. build   every csrc/*.cu kernel with nvcc (one process per source,
             all started together) and print the build seconds, with
             ptxas's registers and spills and the blocks an SM of the f32
             K1 (at each key split), K2/K3, K5 and K6/K7; beside them the
             parent commit's fused_ce.cu (from --parent TREE or git
             history, where either is at hand) for phases 9 and 11;
  2. K4      paged decode attention against its plain PyTorch version at
             the engine's shapes: ragged lengths, mid-block tails,
             trash-padded tables over garbage, a length past MB*BS,
             f32 and bf16, plus head_dim 32/128 and a length-0 slot;
             lengths one row before, on and past a chunk boundary, a
             1-row slot among long ones, every slot at MB*BS; every case
             twice for the same bits; K4 timed with the bound;
  3. K1      flash-attention forward against its plain version for O and
             LSE: [2,12,1024,64], a ragged [1,12,333,64], the serving
             cross-check's longest shape and head_dim-128 cases, causal
             and not, f32 and bf16; bf16 against both plain variants (P
             kept f32, and P rounded to bf16 as the kernel rounds it);
             f32 also at S = 1, 17, 63, 65, 1024 and 2048, D = 128, B*H
             1 .. 96 and an operand not 16-byte aligned, each twice for
             the same bits; the f32 K1 timed twice in turns with SDPA's f32
             forward, at [1,12,661,64] and [8,12,1024,64] causal, with
             TFLOP/s and the share of the bound; phase 21's shapes non-
             causal: BERT's [32,12,128,64] f32 and bf16, the encoder's
             [8,12,512,64] f32;
  4. serve   GPT-124M (random weights from a seeded torch.Generator) in
             ServingEngine(num_slots=8, block_size=16, async_depth=1):
             16 greedy requests in two staggered waves, four sharing a
             256-token prefix; K4 launches must equal decode steps x 12;
  5. check   every request's stream against the teacher-forced argmax of
             the port's own forward (through K1): a token may differ only
             where the reference's top-2 logit margin is below 1e-4;
  6. K2/K3   flash-attention backward (dQ; dK and dV) against the plain
             backward: the training shape [8,12,1024,64] causal f32 and
             bf16, a ragged [1,12,333,64] causal and not, D = 128 at
             [1,4,200,128] and [2,3,65,128]; bf16 against both plain
             variants (P and dS kept f32, and rounded to bf16 as the
             kernels round them); every case run twice for the same
             bits; K2, K3, the plain backward and the backward of
             PyTorch's scaled_dot_product_attention timed at the training
             shape in f32, with SDPA's backward around them (median and
             spread), and in bf16 (the flagship's dtype)
             with K1, SDPA's forward and SDPA's backward three times
             between them, with TFLOP/s and the fraction of the bound;
             then phase 21's shapes non-causal, checked as the others
             ([32,12,128,64] f32 and bf16, [8,12,512,64] f32), and K1,
             K2, K3 at each timed against the plain versions, the full
             (non-causal) bound and SDPA's forward and backward;
  7. train   GPT-124M with an untied head (random weights from a seeded
             torch.Generator), batch 8 x seq 1024, labels = ids, AdamW(1e-4,
             weight_decay 0.01, ClipGradByGlobalNorm(1.0)), 6 steps: every
             loss finite, the last below the first, K1 = K2 = K3 launches =
             6 x 12; median step ms of steps 2-6, tokens/s, peak memory;
  8. cpu     a 2-layer GPT at full width, untied and tied (the tied one
             puts K5-K7 and K7's dW in the word-embedding grad), batch 1 x
             seq 256, the same weights on the card and on the CPU: 3 AdamW
             steps each, per-step losses and step 1's gradient of every
             parameter within the stated tolerances;
  9. K5-K7   the fused linear cross-entropy kernels (K5 loss and LSE, K6
             dx, K7 dW) against their plain versions at the flagship shape
             (T = 8 x 1024, H = 768, V = 50304, about 5 % of the rows
             ignore_index) in f32 and bf16 and at ragged shapes (T = 1 ..
             1000, H = 13 .. 1536, V = 7 .. 50304); bf16 K6/K7 against
             both plain variants (d kept f32, and d rounded to bf16 as the
             kernels round it); every case twice for the same bits, the
             f32 K5's loss and LSE within the same tolerance of the
             parent's; K5, K6, K7 (30 calls in bf16), the plain forward
             and backward and, as a yardstick, the two-call composition
             F.cross_entropy(F.linear) forward and backward timed in both
             dtypes, with TFLOP/s and the fraction of the bound; the f32
             K5 timed in turns with the parent's (this tree, parent,
             parent, this tree), every turn faster than every one of the
             parent's;
 10. flagship the reference's flagship training step
             (tools/baseline_bench.py bench_gpt): GPT-124M with the default
             tied head, dropout 0, batch 8 x seq 1024, labels = ids,
             AdamW(1e-4, weight_decay 0.01), under
             amp.auto_cast(level="O1", dtype="bfloat16"), 6 steps: every
             loss finite, the last below the first, K1 = K2 = K3 launches
             = 6 x 12 and K5 = K6 = K7 = 6; median step ms, tokens/s, peak
             memory;
 11. f32     the same step in f32 (no auto_cast, TF32 off): the tied
             head through the f32 K5, K6 and K7 once a step; the same
             gates and numbers. Then, where the parent's K5 was
             built, the same 6 steps with it, in turns (this tree,
             parent, parent, this tree): every step's loss within 1e-4
             relative (the sums run in another order), peak memory no
             more than the parent's + 64 MiB, and each side's median step
             over its two runs;
 12. optim   phase 8's tied 2-layer GPT at full width, batch 1 x seq 256,
             the same weights on the card and on the CPU: 3 steps of each of
             SGD, Momentum, Adamax, Adagrad, RMSProp, Lamb, LarsMomentum,
             Adadelta and Ftrl, of Adam with an L1Decay and a
             ClipGradByValue, and of AdamW over two param groups: every
             step's loss within LOSS_RTOL of the CPU's, and every
             parameter's move within the stated tolerance of the CPU's.
             Then on the card AdamW with a schedule: 2 steps,
             state_dict(), a fresh model and optimizer loaded, 2 more steps
             give the bits of 4 straight steps. K1-K3 = 82, K5-K7 = 41;
 13. recompute phase 11's step with TransformerLMConfig(recompute=True), 6
             steps: losses within 1e-5 relative of phase 11's, K1 = 2 x 6 x
             12 (each block's forward again in the backward), K2 = K3 = 72,
             K5-K7 = 6, peak memory below phase 11's, step ms beside it;
             then 2 steps of phase 10's O1 bf16 step with recompute: losses
             within 1e-3 relative of phase 10's first two (the
             recomputation casts as its forward did);
 14. generate GPT-124M (phase 4's weights) model.generate(): greedy, 4
             prompts of 128 tokens, 96 new: every token the teacher-forced
             argmax of the port's forward (through K1) and the
             ServingEngine's stream for the prompt (through K4), either
             differing only at a top-2 margin below 1e-4; top-k 40 at
             temperature 0.8, seed 1 twice: the same tokens, each within
             the teacher-forced top 40 (less 1e-4); beam search (4 beams,
             batch 2, 32 new) on phase 8's 2-layer model, card against
             CPU, the same tokens; generated tokens/s of greedy and beams;
 15. rest    the rest of the serving engine on phase 4's GPT-124M, seed
             and 16 requests in phase 4's two waves, num_slots 8, every
             stream held to phase 5's rule (token for token, or parting at
             a top-2 margin below 1e-4 in the port's forward; for a
             sampled token the margin of the logits the head draws from)
             and each run's tokens/s printed beside phase 4's: 15a the slot
             pool (paged=False, max_len 1024) at async_depth 1 and 0
             against phase 4's streams; 15b prefill_chunk 128 under a
             256-token budget on both pools against the same pool
             unchunked, with the chunk dispatches; 15c speculative
             decoding (spec_k 4) on both pools against phase 4, with the
             drafted and accepted tokens and the acceptance rate; 15d
             sampling=True with 8 greedy and 8 sampled requests
             (temperature 0.8, top-k 40, top-p 0.95, seeds 0-7) on both
             pools: greedy rows against phase 4, a second run the same
             bits, the sampled rows across pools and chunking, and phase
             8's 2-layer model card against CPU; 15e a role="prefill"
             engine (hold_kv, max_new_tokens 1) exporting each prompt
             through json.dumps/loads into a role="decode" engine against
             phase 4, the wire bytes a prompt token and the handoff ms,
             and one flipped byte refused with KVWireError, the pool
             unchanged. On every paged run K4 = 12 x its plain decode
             steps (verify steps attend in plain torch), set to 0 before
             and read after; every pool conserved and empty at the end.
 16. fleet   the hardened engine and the router on phase 4's GPT-124M,
             weights and 16 requests, every replica a ServingEngine(
             paged=True, num_slots=8, block_size=16) on the card with its
             own replica_id, every stream held to phase 5's rule against
             phase 4's: 16a Router over two InProcessTransport replicas
             (EngineGateway stepping threads), its state() keys, tokens/s
             beside phase 4's and each replica's share, then the same
             requests to the two gateways and to one straight from the
             main thread (no router threads); 16b the same
             router with replica r0 killed once two of its requests are
             streaming: every request completes by journal replay, >= 1
             failover, the kill -> done wall; 16c one engine under
             FaultPlan(seed=13) at DEFAULT_RATES with max_dispatch_retries
             8, twice: a non-empty fault log, the same both runs, no abort;
             16d supervisor=True with a wedged decode: queue_stall fires,
             exactly one restart, health degraded during the replay and
             healthy after, the peak memory over the start below a
             second pool (the old one is freed first); 16e one
             replica behind EngineGateway.serve() on 127.0.0.1 and a
             router over HTTPTransport: 4 requests, GET /metrics and
             /debug/health answer 200. Every run's pool conserved and
             empty; K4 = 12 x its engines' decode steps.
 17. observe the observatories and the fleet telemetry on phase 4's
             GPT-124M, weights and 16 requests, spread over three
             tenant_ids, on ServingEngine(paged=True, num_slots=8,
             block_size=16) with perf, the cache observatory, trace
             spans and SLO targets on: 17a every stream held to phase
             5's rule against phase 4's, the pool conserved and empty;
             17b the decode program's roofline floor equal to this
             script's reckoning (parameters once, each slot's live K/V
             read and its new row written, over HBM_BPS), its roofline
             fraction in (0, 1], attributed_fraction printed, the MFU
             gauge in (0, 1), the HBM gauges within a pool block of
             torch.cuda.memory_allocated; 17c tokens per tenant summing
             to the engine's, SLO attained + violating = completed,
             /debug/requests?tenant= exactly that tenant's, one trace a
             request from /debug/traces through the TraceAssembler,
             /debug/cache with the cache keys and an MRC, every route
             200; 17d two replicas behind EngineGateway.serve() with a
             FleetPoller and a FleetServer: both up and healthy, the
             rollup's sums equal the replicas', /fleet/* 200, one killed
             and down after down_after cycles with one replica_flap for
             it alone; 17e tokens/s with every observatory on and off
             (perf, cache, trace spans, health), on/off/off/on, then on
             with a poller scraping every 0.25 s, each beside phase 4's.
             K4 = 12 x each run's decode steps.
 18. drill   the fleet over replica processes (paddle_tpu_torch.tools:
             replica_worker, router_drill, fleet_top) on phase 4's
             GPT-124M, weights (one seeded CPU generator in every process)
             and 16 requests, each replica a ServingEngine(paged,
             num_slots=8, block_size=16) on the card in a process of its
             own, the kernels built once by this process: 18a the router
             drill over 3 replica processes, one SIGKILLed with requests
             in flight (every request completes, one trace each, the
             survivors idle and conserved, the no-failover baseline
             loses), the kill -> done wall; 18b the same with 1 prefill +
             2 decode replicas and the prefill one killed mid-handoff
             (handoffs > 0); 18c routed tokens/s over 2 replica
             processes, the 2 in-process replicas of 16a and one engine,
             in turns, twice, beside phase 4's; 18d fleet_top over the 2
             processes: exit 0, then 1 naming the one killed; 18e the
             lock patrol armed over one in-process gateway (no finding
             outside DEFAULT_PATROL_ALLOW), tokens/s armed against off.
             Every stream held to phase 5's rule against phase 4's; every
             worker reports K4 = 12 x its decode steps.
 19. core    the Paddle-style eager core: set_device("gpu"), to_tensor
             on cuda:0 and its Place; 19a a loss of Tensor operators and
             core ops around the core's attention op at the training
             shape [8,12,1024,64] causal f32: K1 forward, K2/K3 in
             backward(), the grads against the same computation in plain
             torch through the same kernels (bits, or phase 6's
             tolerance); 19b paddle.grad(create_graph=True): a gradient
             penalty through matmul/add/tanh against torch.autograd.grad,
             x**4's first three grads; 19c a PyLayer, no_grad; 19d a
             double grad through the attention op (K2/K3's first order,
             the composition's second) against torch's double grad of
             the composition.
 20. nn      the Paddle nn surface: phase 7's untied GPT-124M written as
             a user would in it (paddle_surface_gpt: nn.Layer,
             nn.Embedding, nn.LayerList, nn.LayerNorm, nn.Linear,
             paddle.reshape/transpose/unbind, nn.functional's
             scaled_dot_product_attention, gelu and cross_entropy), 8 x
             1024, f32, dropout 0, phase 7's initial weights carried in
             (each Linear weight transposed into [in, out]); 20a a
             transposed-and-unbound q/k/v launches K1; step 1's loss
             within LOSS_RTOL of phase 7's, every grad within GRAD_TOL
             of the torch GPT's; 20b 3 AdamW steps with
             ClipGradByGlobalNorm(1.0): each loss within LOSS_RTOL of
             phase 7's, each parameter's move within phase 12's L2 rule,
             K1 = K2 = K3 = 12 a step, step ms and peak memory beside
             phase 7's; 20c the core's host time an op (add, matmul,
             reshape, layer_norm, a Linear call) against the same torch
             calls, in turns; 20d Dropout's keep share within 6 sigma,
             the same seed the same mask and randn, Linear's Xavier std,
             torch's global RNG untouched.
 21. bert    BERT-base pretraining and the Paddle surface's part B: 21a
             a float and a bool mask on [32,12,128,64] through SDPA and
             the core's op give reference_attention's bits, K1 launched
             0 times; 21b the reference's config 3 (tools/baseline_bench.py
             bench_bert) eager: bert_base(max_seq_len=128, dropout=0.0)
             from a seeded generator, AdamW(1e-4, weight_decay 0.01),
             amp.auto_cast O1 bf16, bench_bert's batch 32 x 128 from
             RandomState(0), 8 steps: every loss finite, the last below
             the first, K1 = K2 = K3 = 12 a step; median step ms of steps
             2-8, samples/s, tokens/s, peak memory; 21c a 2-layer
             BertForPretraining at width 768, 12 heads, vocab 30522,
             [2, 128], f32, the same weights on the card and the CPU: the
             loss within LOSS_RTOL, every grad within GRAD_TOL, one AdamW
             step's moves within phase 12's rule; 21d the Paddle
             surface's TransformerEncoder (d_model 768, 12 heads, 3072,
             12 layers, post-norm, f32) on [8, 512, 768]: output and
             grads against the same layers through the composition, 2
             AdamW steps at K1 = K2 = K3 = 12, a src_mask call with no
             K1, save/load of the layer and optimizer into fresh objects
             whose next step gives the uninterrupted step's bits; 21e
             Embedding(1_000_000, 768, sparse=True) under Adam lazy and
             not, 4096 lookups over 768 rows: the grad sparse, its
             coalesced rows under 1/1000 of the dense grad's bytes, step
             2's peak over its start under one dense grad, touched rows
             a dense-grad Adam's, untouched rows unchanged when lazy;
             21f solve, cholesky, svd, qr, eigh, lu, det and lstsq on
             f32 and f64 batches held to the CPU tests' invariants.
 22. vision  the vision surface, which runs no TPU kernel (the reference
             computes it in XLA: cuDNN's convolutions and plain torch
             here, so no kernel row): 22a ResNet-50's ops at its shapes
             with batch 2, card against CPU in f32 (the 7x7/2 stem, a
             bottleneck's 1x1 and 3x3/2, the 1x1/2 downsample,
             MobileNetV2's depthwise 3x3/2, MaxPool2D(3, 2, 1) with its
             grad and mask on planted ties (bits), BatchNorm2D train with
             the running buffers after the step and eval,
             AdaptiveAvgPool2D((1, 1)), interpolate in each mode and
             alignment, grid_sample in each padding); 22b the reference's
             config 2 (bench.py:186-211) eager: resnet50(num_classes=1000)
             from paddle_tpu_torch.seed(0), Momentum(0.1, 0.9,
             weight_decay 1e-4), CrossEntropyLoss under amp.auto_cast O2
             bf16, the same seeded batch of 128 x [3, 224, 224] for 8
             steps: every loss finite, the last below the first; median
             step ms of steps 2-8, samples/s, the steps' own peak memory;
             two steps under torch.profiler: the idle share, then with a
             sync closing forward, backward and optimizer, launches and
             device ms a step by class; eval() and the O2 forward's
             images/s, its argmax the f32 forward's on every row with a
             clear margin; 22c resnet18(num_classes=10) built on the CPU
             and its card twin, 2 Momentum steps on [2, 3, 64, 64]: the
             losses, every grad and the running statistics; LeNet and
             mobilenet_v2 (eval) forward; 22d the reference's config 1
             (tools/baseline_bench.py:27-45): LeNet, Adam 1e-3, batch 64,
             20 steps eager, the median step ms.
 23. rnn     the recurrent surface, which runs no TPU kernel (the reference
             computes it with lax.scan, optax and jnp: torch's fused RNN
             ops, cuDNN's in f32, and plain torch here, so no kernel row):
             23a its ops card against CPU in f32: LSTM, GRU, SimpleRNN
             (tanh, relu) at [128, 24, 512], 2 layers, forward and
             bidirectional (outputs, final states, the grads of the input
             and of every weight), LSTMCell and GRUCell, ctc_loss at
             DeepSpeech2's [T=200, B=16, C=29] (unnormalised, repeats, an
             infeasible row), hsigmoid_loss over 7709 classes at [1280,
             512], gather_tree [32, 128, 10], linear_chain_crf and
             crf_decoding at Conll05's 67 labels; the kernels a 2-layer
             LSTM launches in f32 and under O2 (bf16), cuDNN's warnings,
             the port's LSTM against nn.LSTM over one flat buffer; 23b
             PaddleNLP's seq2seq (IWSLT15 en-vi widths: vocabularies
             17191 / 7709, 2 x 512 LSTMs, dropout 0.2, Uniform(-0.1,
             0.1)) without attention through paddle_tpu_torch.Model.fit
             over DataLoader(WMT16, batch 128, pad to the longest), Adam
             1e-3 + ClipGradByGlobalNorm(5.0), 4 epochs = 8 steps in f32:
             every loss finite, the last below the first; median step ms
             of steps 2-8, target tokens/s, the steps' own peak memory;
             two train_batch calls under torch.profiler: idle share,
             launches a step, device ms a step by class; evaluate over
             WMT16's test split; 23c BeamSearchDecoder + dynamic_decode
             (beam 10, 32 steps) at batch 128 on the trained weights,
             sequences/s, and 8 rows card against a CPU twin (phase 5's
             rule); 23d the same model at hidden 64, vocabularies 500 /
             400, 2 Adam steps card against CPU (losses, every grad), and
             DataLoader(num_workers=2) against num_workers=0 on the card.
 24. static  jit.to_static: each step captured as a CUDA graph and
             replayed (call 1 eager, 2 eager under record, 3 capture and
             replay, then replays), against the same step eager from the
             same seed and batch, in turns; 24a a 2-layer GPT at full
             width [2, 1024], forward and backward captured and AdamW
             eager outside, untied and tied, f32 and O1 bf16: each loss
             and every grad the eager run's bits, K1-K3 (and tied K5-K7)
             launches the eager run's (captured x replays + the eager
             calls); 24b config 2 as bench.py:186-206 writes it (phase
             22b's step in jit.to_static), 24c config 3
             (tools/baseline_bench.py:87-107, phase 21b's step), 24d the
             flagship (tools/baseline_bench.py:163-197, phase 10's step),
             24e config 1 (tools/baseline_bench.py:27-82, LeNet), each
             eager, captured, eager, captured over 10 calls (LeNet 20):
             the losses of every run the first's, 24b's 53 batch norms'
             running statistics too, launches K1-K3 = 12 a call (24c,
             24d) and K5-K7 = 1 (24d); eager beside captured: the median
             step ms, samples/s or tokens/s, the idle share over 3
             profiled calls, the peak memory and the graph pool's bytes,
             the capture ms; 24c and 24e compare their runs within
             STATIC_TOL (eager itself parts between runs), then once more
             eager against captured under torch's deterministic
             algorithms, bit for bit, and name the parameters whose
             grads part over 5 eager backward passes from one state (24c
             also counts the distinct eager losses of one state over 20
             forwards); 24e then Model.fit on LeNet after
             enable_static() against the dygraph fit, both under
             deterministic algorithms (every batch's loss, evaluate,
             predict); 24f a StepDecay stepped between
             replays gives the eager losses and weights, dropout masks
             differ on every call, and a float() of a Tensor, a torch
             .item(), a Tensor `if`, an enabled GradScaler and a
             rebinding inside a captured step raise ToStaticError with
             the card working on after; 24g distribution on the card:
             Normal, Uniform and MultivariateNormalDiag samples' moments,
             Categorical and sampling_id frequencies by chi-square, and
             each log_prob, entropy and KL against the CPU's; 24f's
             Tensor `if` raises only where no dy2static conversion
             reached it (enable_ast=False, an unconverted callee).
 25. dy2st   dy2static and the static graph: 25a dy2static's scenarios
             (if/elif/else, guard clauses and nested returns, a Tensor
             while, a Tensor-bounded for with break and continue, for
             over Tensor rows, a return inside a loop, and/or/not, and a
             branch that indexes out of range unless its predicate
             holds) through jit.to_static on CUDA tensors over 8 calls,
             each against the same converted function eagerly on the
             CPU: one graph a case, its 6 replays taking the branch and
             the trip count the data picks (CUDA conditional nodes,
             csrc/graph_cond.cu), the out-of-range branch never run;
             25b phase 24d's flagship step with a loss-spike guard (a
             Tensor `if` on the detached loss against a 0-d Tensor that
             alternates between calls): 10 calls eager against captured,
             losses and weights bit for bit, one graph, K1-K3 = 12 and
             K5-K7 = 1 a call, step ms, idle share, peak and pool; 25c
             phase 20's surface GPT-124M (phase 7's weights) as a static
             program under enable_static() + program_guard (static.data,
             F.cross_entropy, AdamW + ClipGradByGlobalNorm(1.0) minimize)
             trained 10 steps through Executor.run (one CUDA graph for
             the feed signature) against 10 of phase 20b's eager steps
             from the same weights: step 1's loss within LOSS_RTOL of
             20b's, every step's within LOSS_RTOL of the eager steps
             with the position embedding frozen (the reference's program
             computes the position lookup eagerly while it is built, so
             the embedding gets no grad; the distance to 20b's steps is
             printed), K1-K3 = 12 a step, step ms, idle share, peak and pool beside the
             eager steps'; clone(for_test=True) leaves the weights; 25d
             with birth tracking on, a Tensor leaked out of a captured
             branch raises TracerLeakError naming its op, file:line and
             scope, and the card works on.
 26. deploy  phase 20's surface GPT-124M (phase 7's weights, f32) as a
             user deploys it: first the f32 K1 at the batch-1 Predictor's
             [1,12,1024,64] causal shape against its plain version, timed
             with SDPA and the bound; 26a jit.save with InputSpec([None,
             1024]) (the .pdmodel holds no parameter values), then
             inference.create_predictor on the card through its handles at
             batches 1, 4 and 8, 6 runs each: K1 = 12 a run, one CUDA graph
             a batch size, every run the eager model's logits bit for bit
             (or within DEPLOY_TOL), run ms host to host and device ms,
             tokens/s, peak memory and the graph pool beside the eager
             forward's; batch 1 against the CPU twin (jit.load on the CPU)
             within LOSS_RTOL of the largest logit; jit.load = the
             Predictor; a PredictorPool of 4 from 4 threads, each its own
             batch's logits; 26b PostTrainingQuantization (abs_max, 4
             calibration batches of 8 x 1024) and convert_to_int8: 49
             Int8Linear with int8 w_q on the card, saved and served at
             batches 1 and 8, the products through torch._int_mm, logits
             within the reference's bar of f32 (max|diff| / max|f32| <
             0.1) with the top-1 agreement, the int8 model's eager bits;
             run ms, tokens/s, peak and .pdiparams bytes against 26a's, the
             GEMMs' device ms int8 against f32 in one profiled forward
             each; 26c ImperativeQuantAware and 3 AdamW steps at 8 x 1024
             through the straight-through estimator (K1 = K2 = K3 = 12 a
             step), save_quantized_model, the Predictor = the eval
             forward; 26d onnx.export at [1, 1024] from the card: the file
             re-parsed, every weight an initializer of the card's bits,
             nodes by type; 26e a changed position embedding in the saved
             .pdiparams: jit.load gives the changed eager model's logits.
 27. lazy    the lazy eager executor: 27a phase 20's surface GPT-124M
             (phase 7's weights, untied f32, 8 x 1024, AdamW +
             ClipGradByGlobalNorm(1.0)) as a plain eager loop
             (loss.backward(); opt.step(); opt.clear_grad(); then
             float(loss)), 10 steps lazily against 10 immediately in turns
             (lazy, immediate, immediate, lazy): every loss and weight
             immediate's bits (else the first sublayer that parts and by
             how much), K1 = K2 = K3 = 12 a step (captured x replays), one
             replay-cache entry, each step's flush form (warm-up, record,
             capture, then a graph replay every step), median step ms,
             idle share over 3 profiled steps, peak memory and the graph
             pool beside the immediate run's; 27e _C_ops.matmul_v2 and
             softmax on the card against the ops, a Profiler with a
             scheduler over three of 27a's steps writing a chrome trace
             with optimizer/step spans and K1-K3's kernels, record_scope's
             counters; 27b config 1 (LeNet, 24e's step) lazily,
             immediately and through to_static under deterministic
             algorithms: losses bit for bit, step ms and idle share each;
             27c config 3 (BERT-base, bench_bert's 32 x 128, O1 bf16,
             AdamW) written in the Paddle surface (paddle_surface_bert,
             the reference's structure and names) with the torch
             bert_base's weights: its f32 loss within LOSS_RTOL of the
             torch model's, 8 steps lazily against immediately under
             deterministic algorithms (bit for bit), then under the
             default ones (K1-K3 = 12 a step, losses within STATIC_TOL
             or one quantum of the O1 loss, a bf16 step of its MLM sum
             over the masked tokens), step ms and idle share; 27d a
             float(loss) before backward() (two segments a step, both
             node by node and counted), the GradScaler's skipped inf step,
             dropout masks new at every replay and the immediate masks of
             the seed, masked_select after a pending graph, a write
             through a view, a set_value between steps and a StepDecay
             stepped between replays (immediate's weights),
             paddle.grad(create_graph=True) at once.
 28. dist    the distributed layer (paddle_tpu_torch.distributed): 28a a
             world of one over NCCL: every collective the identity on a
             CUDA tensor, NCCL's own all_reduce, a DataParallel GPT-124M
             f32 step (8 x 1024) = the plain step bit for bit; 28b two
             NCCL ranks on the one card (reported: NCCL refuses them),
             then two rank processes (spawn, after the build) over gloo:
             GPT-124M with use_mp=True at mp = 2 (vocab 25152 and 6 heads a
             rank, tied head through the vocab-split K5-K7), 8 x 1024, 3
             AdamW steps in f32 and 3 under O1 bf16: both ranks' losses
             equal, within TP_LOSS_RTOL / TP_BF16_LOSS_RTOL of one process
             on the same weights, each gathered leaf after the f32
             steps within TP_WEIGHT_RTOL of its update's norm (the QKV
             biases' key thirds, whose grad is 0, within TP_KBIAS_STEPS x
             lr), the ranks' O1 losses apart from their f32 losses by
             more than TP_O1_FROM_F32 (O1 ran), K1-K3 = 36 and K5-K7 = 3
             a rank, the collectives staged through pinned host memory
             counted; 28c sp = 2 over the same
             ranks: Ulysses (K1, K2/K3 on 6 heads at S = 1024) and ring
             attention at [8,12,1024,64] causal f32, outputs and grads
             against one process's flash attention within SP_TOL; 28d the
             TP shard route of K5-K7 in one process at T = 8192, H = 768,
             V = 50304 over mp = 2 and 4, f32 and bf16: each shard's
             K5-K7 against their plain versions on the shard's inputs
             (shifted labels, the global LSE), then the shards combined
             against the full-vocab K5 (loss and LSE), K6's dx and K7's
             dW slices; each shard call timed with its bound and F.cross_entropy(F.linear) on
             the same shard; 28e the captured flagship step and the paged
             engine's decode lint clean, a planted f64 upcast flagged;
             28f GPT-124M built with use_mp (mp = 2) on the same two
             ranks: greedy generate() of 32 tokens from 4 prompts on each
             rank = one process's dense model's tokens from the same
             weights, and so is each rank's ServingEngine stream; K1 of
             the teacher-forced forward (6 heads a rank) and K4 of the
             engine's decode counted a rank, each held to its plain
             version at those shapes and timed (the kernels line's rows).
 29. rest    the rest of the distributed layer on 2 rank processes
             started by the port's launcher (launch_mod.spawn), gloo on
             the one card: 29a GPT-124M at pp = 2 (6 blocks a stage, 4
             microbatches of [2, 1024], 1F1B), 3 f32 AdamW steps of 28b's
             batch: the stages' losses equal and within TP_LOSS_RTOL of
             28b's one process, each gathered leaf by 28b's rule, the tied
             embedding's two copies bit-equal, K1-K3 = 72 a stage and
             K5-K7 = 12 on the last, the bytes staged through pinned
             memory; 29b ZeRO-2 (os_g, sharding = 2, each rank [4, 1024]):
             the mean of the ranks' losses and the gathered leaves the
             same way, each rank's optimizer state at most
             ZERO_STATE_SHARE of one process's, the ranks' train state
             saved with save_sharded_train_state and loaded by this
             process bit for bit; 29c the MoE layer at ep = 2 (MOE:
             d_model 768, hidden 3072, 8 experts, top-2, 8192 tokens,
             f32): output, aux loss and grads against one process's
             within MOE_TOL of each largest, one GradientMerge and one
             DGCMomentum step against their plain steps; K1-K3 and K5-K7
             at a stage's and a ZeRO rank's shapes held against their
             plain versions and timed (the kernels line's rows).
 30. fluid   the fluid compat layer (paddle_tpu_torch/fluid/): 30a the
             fluid-1.x ResNet-50 program of PaddleCV
             image_classification (fluid.layers, [32, 3, 224, 224] f32,
             Momentum 0.9, L2Decay 1e-4, piecewise_decay) through
             fluid.Executor(CUDAPlace(0)), 10 steps against the same
             fluid code eager under fluid.dygraph.guard() from the same
             weights (each step's loss within LOSS_RTOL, the moving
             statistics within FLUID_STAT_TOL), save_persistables ->
             load_persistables into a fresh program the same next loss
             bit for bit, step ms, idle share and peak; 30b PaddleNLP's
             PTB LM "small" with StaticRNN, 10 Executor.run steps, the
             first 3 against the same program on the CPU within
             LOSS_RTOL; 30c While programs (the fed bound, assign's
             copy) on the card = the CPU's, one graph; cond, case,
             switch_case and the arrays under to_static = eager on the
             CPU, one graph; 30d phase 7's untied f32 GPT-124M through
             fluid.io.save_inference_model (jit.save's torch.export
             path: one K1 custom-op node a layer) and a Predictor at
             batches 1 and 8, 6 runs each: K1 = 12 a run, the eager
             model's bits or DEPLOY_TOL, run and device ms; onnx.export
             of it re-parsed, every initializer the card's bits; the K1
             rows at [1|8,12,1024,64] through the operator; 30e the
             legacy collective fleet: 3 minimize steps of GPT-124M at 8
             x 1024 = a plain AdamW's losses and weights bit for bit,
             K1 = K2 = K3 = 12 a step.
 31. incubate the last modules: 31a GPT-3 1.3B (text.models.gpt3_1p3b,
             the reference's config 5: 24 layers, hidden 2048, 16 heads
             of 128; seeded random weights) at 4 x 1024 under
             amp.auto_cast O1 bf16, pruned 2:4 by incubate.asp
             (mask_1d, every 2-D parameter as the reference prunes,
             the card's masks of two weights = numpy's), 10 steps of
             asp.decorate(incubate.LookAhead(AdamW, alpha 0.5, k 5))
             with incubate.ModelAverage: every loss finite and the
             last below the first, check_mask_1d on the card for
             every masked weight after every step, 4 tensors = mask *
             (slow + alpha (fast - slow)) bit for bit at steps 5 and
             10, apply() = the sum / 10 and restore() the same bits,
             K1 = K2 = K3 = 240 and K5 = K6 = K7 = 10; median step
             ms, tokens/s, peak; 31b from the average: generate() of
             32 greedy tokens for 4 prompts, every token the teacher-
             forced forward's argmax or a near-tie (K1 f32 at head
             dim 128), the engine's streams against it (K4 = 24 x its
             decode steps at 16 heads of 128); 31c K1-K3 at
             [4,16,1024,128] causal bf16 and K5-K7 at [4096, 2048,
             50304] bf16 (5 % ignored) against their plain versions
             (bf16 tolerances), K4 and the f32 K1 at 31b's shapes,
             each timed with its bound and library call (the kernels
             line's rows); 31d incubate.checkpoint.auto_checkpoint:
             GPT-124M cut to 2 blocks, f32, 2 AdamW steps an epoch, a
             child process runs 2 of 3 epochs and exits, a second
             resumes at epoch 2 under the same PADDLE_JOB_ID and
             finishes, its losses and weights equal to an
             uninterrupted child's bit for bit (torch's deterministic
             algorithms); 31e softmax_mask_fuse and its causal form at
             [4,16,1024,1024] bf16 against the f32 composition, a
             cpp_extension host op (g++) on CUDA tensors = numpy,
             set_cuda_rng_state(get_cuda_rng_state()) replaying
             paddle.rand.
Then the card's name and power limit, one JSON line of kernel numbers
(launches summed over the main paths: phases 4, 14, 15's paged runs,
16, 17 and 18 (its replica processes' and this process's) for K4, 5,
14, 16, 17 and 18 for the serving K1 row, 7, 11, 12, 13, 19 and 20 for
the f32 training rows (and 25c's program, 26's batch-8 Predictor runs,
its QAT steps and 27a's lazy runs), 26's batch-1 and batch-4 Predictor runs for the
[1,12,1024,64] row, 10, 13, 24d's and 25b's captured runs for the bf16
ones;
the non-causal rows 21b, 24c's captured runs and 27c's lazy runs (bf16
[32,12,128,64]), 21c (f32 [32,12,128,64], its card side at
[2,12,128,64]) and 21d ([8,12,512,64]); 28b's ranks for the TP shard
rows at [8192, 768, 25152] (none runs mp = 4: the [8192, 768, 12576]
rows read 0), 28c's for the Ulysses rows, 29a's stages and 29b's ranks
for theirs, 28f's ranks for the TP rank's K1 and K4 rows, 30d's
Predictor runs for the exported node's K1 rows, 30e's steps on the f32
training rows, 31a's steps for the head-dim-128 K1-K3 and the H = 2048
K5-K7 rows, 31b's decode and forward for its K4 and f32 K1 rows), and
as the last line
{"ok": true, "device": {...}}.

TF32 is off for matmuls and cuDNN, so every f32 product is full f32.
Any failure raises: the exit code is non-zero and no "ok" line prints.
Without a CUDA device, or without the package beside this file, it
exits non-zero at once.
"""
import argparse
import base64
import contextlib
import ctypes
import functools
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# peaks of one H100 SXM (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

F32_TOL = 1e-5    # f32 sums over <= 1024 rows, only their order differs
F32_FLASH_TOL = 2e-5   # f32 flash: 64-key tiles rescaled, O(1) values
BF16_TOL = 2e-2   # kernel output rounded to bf16 (half an ulp at |x|~4)
TIE_MARGIN = 1e-4
# K2/K3 grads against the plain backward, relative to the largest grad:
# f32 sums over up to 1024 rows in another order; bf16 grads are rounded
BWD_F32_TOL = 1e-4
BWD_BF16_TOL = 2e-2
# bf16 K2/K3 against the plain backward that rounds P and dS to bf16 as the
# kernels (and the Pallas kernels) do: half a bf16 ulp of the largest grad
# for the kernels' final rounding, plus an occasional P or dS element that
# an exp or a sum in another order rounds the other way
BWD_BF16P_TOL = 5e-3
# card against CPU, the same f32 model: sums in another order (cuBLAS vs
# the CPU's BLAS); losses relative, grads relative to each parameter's
# largest grad
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
TRAIN_STEPS = 6
# K5 against its plain version: the loss and LSE are f32 sums over H and
# a logsumexp over V = 50304 on both sides, in another order; K6/K7
# relative to the largest grad: f32 sums over V or T in another order,
# bf16 grads rounded once (half an ulp is 2e-3 of the value)
CE_LOSS_TOL = 1e-4
CE_F32_TOL = 1e-4
CE_BF16_TOL = 1e-2
# bf16 K6/K7 against the plain backward with d rounded to bf16 as the
# kernels (and the Pallas kernels) round it: half a bf16 ulp of the
# largest grad for the kernel's final rounding (at most 2^-8 = 3.9e-3 of
# it), plus f32 sums in another order
CE_BF16D_TOL = 5e-3
# bf16 K1 against the plain version that rounds P to bf16 over 64-key
# blocks as the kernel does: both round O once (2^-8 of |O|), and an exp or
# a sum in another order can round a P element or O the other way; LSE
# is f32 on both sides (sums over up to 1024 keys, exp2 for exp)
BF16P_TOL = 1e-2
FLASH_LSE_TOL = 5e-5
# the commit whose f32 K5 (the port's first one) phases 9 and 11 hold the
# redesigned one against, where its source is at hand: {(source, symbol):
# ctypes argtypes of its C entry point}. Its K5 has this tree's signature,
# so the wrapper launches it (parent_kernels), with the parent's own vocab
# split of its 64-row tiles (its _FWD_SPLIT[torch.float32])
PARENT = "911c96e"
PARENT_SYMBOLS = {("fused_ce", "fused_ce_forward"): (
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])}
PARENT_F32_SPLIT = (64, 4)
FLAGSHIP = dict(batch=8, seq=1024)
# phase 21: BERT-base pretraining's attention (tools/baseline_bench.py
# bench_bert: batch 32 x seq 128, 12 heads of 64, non-causal) and the
# TransformerEncoder at BERT-base width on [8, 512, 768]
BERT = dict(batch=32, seq=128)
BERT_SHAPE = (32, 12, 128, 64)
BERT_CARD_SHAPE = (2, 12, 128, 64)   # 21c's card side, [2, 128] in f32
ENCODER_SHAPE = (8, 12, 512, 64)
# phase 21e: a 1M-row table at BERT-base width, 4096 lookups a step over
# 768 distinct rows
SPARSE = dict(vocab=1_000_000, dim=768, ids=4096, distinct=768)
# 21e, sparse against dense-grad Adam, element by element: an element
# whose grads are all 0 or at least 1000 x Adam's epsilon (1e-8) moves by
# lr m / sqrt(v) with epsilon out of it, so it carries only the grads'
# relative rounding (sums of about 5 lookups in another order) and the
# final subtraction's: 1e-5 is 20 ulps of a weight of 4 (N(0, 1) rows)
# and 1/1000 of the 2 x lr the two steps move it. An element with a grad
# under the floor is left out of this check (not of the L2 one)
SPARSE_GRAD_FLOOR = 1e-5
SPARSE_EL_TOL = 1e-5
OPTIM_STEPS = 3
# phase 12, card against CPU after 3 steps: per parameter, the L2 norm of
# the difference between the card's and the CPU's move within this share
# of the CPU's move. The updates linear in the grad (SGD, Momentum, RMSProp
# with epsilon inside its root, LarsMomentum, Adadelta) carry the grads'
# rounding differences (phase 8) as they are; the ones that divide a grad
# by its own size (Adam, Adamax, Adagrad, Lamb, Ftrl) turn an element whose
# grad is near 0 into a step of full size on either side, which a few
# elements of a tensor add to its norm. Every element within twice the
# largest move; the key third of each QKV bias (its true grad is 0, all
# noise) is held to that alone
OPT_LINEAR_TOL = 1e-3
OPT_SIGN_TOL = 5e-2
# phase 21d, MultiHeadAttention's routes on the same 12 post-norm layers,
# each held to an f64 run of the composition, every grad relative to its
# tensor's largest. The q and k grads come from dS = P (dP - rowsum(P dP)),
# which cancels where attention is near uniform. The composition's softmax
# backward takes P normalised by its own row sum and the rowsum over the
# very P and dP that dS is made of; the flash formulation (the reference's
# Pallas path, attention.py:286, and K2/K3) recomputes P as exp(S - LSE)
# from the forward's LSE, and takes the rowsum as delta = rowsum(dO O), so
# that dS's rows need not sum to 0. K2/K3's plain version, run with each P
# and each rowsum, is held to the flash route's bound while it keeps
# exp(S - LSE), to the composition's with the softmax's P. Each bound is
# 1.5x a route's reading on the card (NVIDIA H100 80GB HBM3, 700 W): the
# flash route's 1.64e-2 and 1.70e-2, the composition's 4.68e-3
FLASH_ROUTE_GRAD_TOL = 2.5e-2
COMPOSITION_GRAD_TOL = 7e-3
RECOMPUTE_F32_RTOL = 1e-5
RECOMPUTE_BF16_RTOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bound(nbytes, flops, dtype):
    """(bound_ms, bound_by): the larger of bytes over the memory rate
    and operations over the peak rate for the dtype."""
    t_bytes = nbytes / HBM_BPS
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters=30, warmup=3):
    """Mean device time of one call: CUDA events around each call, the
    50 MB L2 flushed before each by reading 256 MB (a decode step finds
    each layer's cache cold; a read leaves no dirty lines for the timed
    call to write back). The card then sleeps about 0.1 ms before the
    start event, so that the host has queued the call before the card
    reaches it: a kernel of tens of microseconds is not timed with the
    host's Python between its two events."""
    flush = torch.zeros(64 << 20, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.max()
        torch.cuda._sleep(200_000)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


# ---------------------------------------------------------------- phase 1

def ptxas_lines(log):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: the kernel's
    name (``flash_bwd_dq_mma_kernel<64>`` through ``c++filt``, of the
    toolchain nvcc uses; the mangled name without it), its registers and
    its stack and spills."""
    kernels, stats, spill = [], [], ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernels.append(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            stats.append(f"{line.split(':', 1)[1].strip()}; {spill}")
    try:
        names = subprocess.run(["c++filt"], input="\n".join(kernels),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines() or kernels
    except OSError:
        names = kernels
    names = [re.sub(r"^void |\(.*", "", n.replace("(anonymous namespace)::",
                                                   "")) for n in names]
    return [f"{n}: {st}" for n, st in zip(names, stats)]


# ---------------------------------------------------------------- phase 2

def paged_case(torch, S, nh, hd, BS, MB, lengths, dtype, seed):
    """Engine layout: block 0 is trash (filled with 1e4 garbage), slot s
    owns blocks 1 + s*MB .. for its live prefix, padding entries name
    trash, and rows past each length inside a slot's own blocks hold
    garbage too (a recycled slot's previous tenant)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    NB = S * MB + 1
    kc = torch.randn(NB, nh, BS, hd, generator=g, device="cuda")
    vc = torch.randn(NB, nh, BS, hd, generator=g, device="cuda")
    q = torch.randn(S, nh, hd, generator=g, device="cuda")
    kc[0] = 1e4
    vc[0] = 1e4
    tables = torch.zeros(S, MB, dtype=torch.int32)
    for s, n in enumerate(lengths):
        used = min(-(-max(n, 0) // BS), MB)
        tables[s, :used] = 1 + s * MB + torch.arange(used)
        for r in range(max(n, 0), used * BS):
            b = int(tables[s, r // BS])
            kc[b, :, r % BS] = 1e4
            vc[b, :, r % BS] = 1e4
    dt = getattr(torch, dtype)
    return (q.to(dt), kc.to(dt), vc.to(dt), tables.cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def k4_case(torch, pa, label, args, tol):
    """K4 against the plain version in f32 on the same (rounded) inputs,
    on the slots with a length > 0 (one <= 0 must give finite zeros);
    twice for the same bits. Returns the error against the plain
    version."""
    got = pa.paged_decode_attention(*args)
    ref = pa.paged_decode_plain(*(a.float() if a.is_floating_point() else a
                                  for a in args))
    lens = args[4].tolist()
    live = [i for i, n in enumerate(lens) if n > 0]
    dead = [i for i, n in enumerate(lens) if n <= 0]
    torch.cuda.synchronize()
    err = (got[live].float() - ref[live]).abs().max().item()
    check(err <= tol, f"K4 {label}: max abs err {err} > {tol}")
    check(not got[dead].float().abs().any() and bool(
        torch.isfinite(got).all()), f"K4 {label}: a length <= 0 slot is "
          "not zeros")
    check(torch.equal(got, pa.paged_decode_attention(*args)),
          f"K4 {label}: two runs differ")
    print(f"  K4 {label}: max_abs_err={err:.3e} (tol {tol}); a second run "
          "gives the same bits")
    return err


def phase_k4(torch, pa):
    S, nh, hd, BS, MB = 8, 12, 64, 16, 64
    lengths = [1, 16, 17, 300, 555, 1024, 1100, 733]   # 1100 > MB*BS
    out = {}
    for dtype, tol in (("float32", F32_TOL), ("bfloat16", BF16_TOL)):
        args = paged_case(torch, S, nh, hd, BS, MB, lengths, dtype, 1)
        pages, chunks = pa.decode_chunks(BS, MB, hd, args[0].element_size())
        out[dtype] = (k4_case(torch, pa, f"{dtype} S={S} nh={nh} "
                              f"hd={hd} BS={BS} MB={MB} lengths={lengths} "
                              f"({chunks} chunks of {pages} pages)", args,
                              tol), args)
        cr = pages * BS
        cap = BS * MB
        edges = [cr - 1, cr, cr + 1, 1, cap, 2 * cr, 3 * cr - 1, cap + 5]
        k4_case(torch, pa, f"{dtype} chunk edges {edges} "
                f"(chunk {cr} rows)",
                paged_case(torch, S, nh, hd, BS, MB, edges, dtype, 4), tol)
        k4_case(torch, pa, f"{dtype} every slot at MB*BS = {cap}",
                paged_case(torch, S, nh, hd, BS, MB, [cap] * S, dtype, 5),
                tol)
        for hd2 in (32, 128):
            k4_case(torch, pa, f"{dtype} hd={hd2}",
                    paged_case(torch, 3, 4, hd2, 8, 5, [1, 13, 40], dtype, 2),
                    tol)
    k4_case(torch, pa, "float32 length<=0 slots [0, 5, -3]",
            paged_case(torch, 3, 4, 64, 16, 4, [0, 5, -3], "float32", 3),
            F32_TOL)

    err, args = out["float32"]
    q, kc, vc, tables, lens = args
    ms = time_ms(torch, lambda: pa.paged_decode_attention(*args))
    plain_ms = time_ms(torch, lambda: pa.paged_decode_plain(*args))
    rows = sum(min(n, MB * BS) for n in lengths)
    row_bytes = nh * hd * 4
    nbytes = 2 * S * row_bytes + 2 * rows * row_bytes + tables.numel() * 4 \
        + lens.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * rows * nh * hd, "float32")
    print(f"  K4 float32 time {ms:.4f} ms ({b_ms / ms:.3f} of the bound), "
          f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "paged_decode_attention", "route": "cuda",
            "dtype": "float32",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/ops/paged_attention.py:92",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


# ---------------------------------------------------------------- phase 3

def phase_k1(torch, attn, main_shape, train_shape, _build):
    import torch.nn.functional as F
    cases = [((2, 12, 1024, 64), c, dt) for c in (True, False)
             for dt in ("float32", "bfloat16")]
    cases += [((1, 12, 333, 64), c, dt) for c in (True, False)
              for dt in ("float32", "bfloat16")]
    cases += [(main_shape, True, "float32"), (main_shape, True, "bfloat16"),
              ((1, 4, 200, 128), True, "float32"),
              ((1, 4, 200, 128), False, "bfloat16"),
              ((1, 4, 200, 128), True, "bfloat16"),
              ((2, 3, 65, 128), True, "bfloat16"),
              ((1, 3, 1, 64), False, "bfloat16")]
    # the f32 K1's short and long grids, every key split, ragged S
    cases += [((1, 1, 1, 64), True, "float32"), ((1, 1, 1, 128), False,
                                                  "float32"),
              ((2, 3, 17, 64), True, "float32"),
              ((1, 5, 63, 128), True, "float32"),
              ((1, 5, 63, 64), False, "float32"),
              ((2, 2, 65, 64), True, "float32"),
              ((2, 2, 65, 128), False, "float32"),
              ((1, 12, 661, 128), True, "float32"),
              (train_shape, True, "float32"),
              ((1, 4, 2048, 128), True, "float32"),
              ((1, 2, 2048, 64), False, "float32")]
    # BERT's (phase 21): non-causal at its step's shape, and the
    # TransformerEncoder's
    cases += [(BERT_SHAPE, False, "float32"), (BERT_SHAPE, False, "bfloat16"),
              (ENCODER_SHAPE, False, "float32")]
    g = torch.Generator(device="cuda").manual_seed(4)
    main = big = None
    for shape, causal, dtype in cases:
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
                   for _ in range(3))
        scale = 1.0 / shape[-1] ** 0.5
        o, lse = attn.flash_attention_forward(q, k, v, scale, causal)
        # bf16: against P kept f32 and against P rounded as the kernel
        # rounds it
        variants = ([(None, F32_FLASH_TOL, F32_FLASH_TOL)]
                    if dtype == "float32" else
                    [(None, BF16_TOL, FLASH_LSE_TOL),
                     (torch.bfloat16, BF16P_TOL, FLASH_LSE_TOL)])
        line = []
        for p_dtype, tol, ltol in variants:
            ro, rlse = attn.flash_attention_plain(q, k, v, scale, causal,
                                                  p_dtype=p_dtype)
            torch.cuda.synchronize()
            eo = (o.float() - ro.float()).abs().max().item()
            el = (lse - rlse).abs().max().item()
            check(eo <= tol and el <= ltol,
                  f"K1 {shape} causal={causal} {dtype} (P "
                  f"{p_dtype or 'f32'}): O err {eo} > {tol} or LSE err {el} "
                  f"> {ltol}")
            line.append(f"vs P {'bf16' if p_dtype else 'f32'}: O err "
                        f"{eo:.3e} (tol {tol}), LSE err {el:.3e} (tol "
                        f"{ltol})")
            del ro, rlse
        if dtype == "float32":
            again = attn.flash_attention_forward(q, k, v, scale, causal)
            check(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
                  f"K1 {shape} causal={causal} f32: two runs differ")
            line.append("a second run gives the same bits")
        print(f"  K1 {list(shape)} causal={causal} {dtype}: "
              + "; ".join(line))
        if dtype == "float32" and causal and shape == main_shape:
            main = (q, k, v, scale, max(eo, el))
        elif dtype == "float32" and causal and shape == train_shape:
            big = (q, k, v, scale, max(eo, el))

    # an operand one float past a 16-byte boundary: the element-by-element
    # staging, at a short grid and a long one
    for shape in (main_shape, (2, 12, 1024, 64)):
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   for _ in range(3))
        buf = torch.empty(q.numel() + 1, device="cuda")
        shifted = buf[1:].view_as(q)
        shifted.copy_(q)
        got = attn.flash_attention_forward(shifted, k, v, 0.125, True)
        want = attn.flash_attention_forward(q, k, v, 0.125, True)
        ref = attn.flash_attention_plain(q, k, v, 0.125, True)
        torch.cuda.synchronize()
        e1 = max((a - r).abs().max().item() for a, r in zip(got, ref))
        e2 = max((a - w).abs().max().item() for a, w in zip(got, want))
        check(shifted.data_ptr() % 16 and e1 <= F32_FLASH_TOL
              and e2 <= F32_FLASH_TOL, f"K1 {shape} f32, q not 16-byte "
              f"aligned: {e1} from the plain version, {e2} from the aligned "
              "q's")
        print(f"  K1 {list(shape)} causal f32, q not 16-byte aligned: "
              f"{e1:.3e} from the plain version, {e2:.3e} from the aligned "
              f"q's output (tol {F32_FLASH_TOL})")

    key_split = _build.function("flash_fwd",
                                "flash_attention_forward_f32_key_split",
                                [ctypes.c_int] * 3)
    rows = []
    for q, k, v, scale, err in (main, big):
        b, h, s, d = q.shape
        times, libs = [], []
        for _ in range(2):  # in turns with SDPA, whose reading drifts
            times.append(time_ms(torch, lambda: attn.flash_attention_forward(
                q, k, v, scale, True)))
            libs.append(time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True)))
        ms = float(np.median(times))
        lib_ms = float(np.median(libs))
        plain_ms = time_ms(torch, lambda: attn.flash_attention_plain(
            q, k, v, scale, True), iters=10)
        pairs = b * h * s * (s + 1) // 2
        flops = 4 * d * pairs
        b_ms, b_by = bound(4 * b * h * s * d * 4 + b * h * s * 4, flops,
                           "float32")
        print(f"  K1 {list(q.shape)} causal f32 (KS = "
              f"{key_split(b * h, s, d)}): "
              f"{ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s, "
              f"{b_ms / ms:.4f} of its bound {b_ms:.4f} ms ({b_by}); sdpa f32 "
              f"median {lib_ms:.4f} ms of {[round(x, 4) for x in libs]} "
              f"({ms / lib_ms:.2f}x); plain {plain_ms:.4f} ms")
        rows.append({"name": "flash_attention_forward", "route": "cuda",
                     "dtype": "float32",
                     "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
                     "replaces": "paddle_tpu/ops/attention.py:67",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": lib_ms})
    return rows


# ------------------------------------------------------------ phases 4-5

def workload(vocab):
    """16 greedy requests: prompt lengths 16-600, max_new 32-128, four
    sharing one 256-token prefix; two waves of eight."""
    rs = np.random.RandomState(0)
    prefix = rs.randint(0, vocab, 256)
    shared = [np.concatenate([prefix, rs.randint(0, vocab, k)])
              for k in (20, 45, 100, 7)]
    lone = [rs.randint(0, vocab, n)
            for n in (16, 40, 64, 100, 150, 200, 256, 333, 400, 480, 550,
                      600)]
    prompts = [lone[0], shared[0], lone[1], lone[2], shared[1], lone[3],
               lone[4], lone[5],
               lone[6], shared[2], lone[7], lone[8], shared[3], lone[9],
               lone[10], lone[11]]
    max_new = [int(x) for x in rs.randint(32, 129, len(prompts))]
    return prompts, max_new


def phase_serve(torch, model, prompts, max_new, pa, attn):
    from paddle_tpu_torch.serving import ServingEngine
    L = model.cfg.num_layers
    # warm-up on its own engine: cuBLAS handles, allocator, kernel load
    warm = ServingEngine(model, num_slots=8, block_size=16, async_depth=1)
    warm.add_request(prompts[0], max_new_tokens=4)
    warm.run()
    del warm
    torch.cuda.synchronize()

    eng = ServingEngine(model, num_slots=8, block_size=16, async_depth=1)
    pa.paged_decode_attention.launches = 0
    attn.flash_attention_forward.launches = 0
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, max_new_tokens=n)
            for p, n in zip(prompts[:8], max_new[:8])]
    for _ in range(24):
        eng.step()
    reqs += [eng.add_request(p, max_new_tokens=n)
             for p, n in zip(prompts[8:], max_new[8:])]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = eng.metrics.snapshot()
    k4 = pa.paged_decode_attention.launches
    steps = eng.metrics.decode_steps
    for r, n in zip(reqs, max_new):
        check(r.done and len(r.generated) == n,
              f"request {r.rid} incomplete: {len(r.generated)}/{n}")
    eng.pool.check_conservation()
    hits = snap["prefix_cache"]["hits"]
    check(hits >= 3, f"prefix cache hits {hits} < 3")
    check(k4 == steps * L, f"K4 launches {k4} != decode steps {steps} x {L}")
    print(f"  served {len(reqs)} requests, {snap['tokens_generated']} "
          f"tokens in {wall:.3f} s wall: tokens/s {snap['tokens_per_sec']:.1f}"
          f", median TTFT {snap['ttft_p50_ms']:.2f} ms, decode steps "
          f"{steps}, prefix_cache hits {hits} (cached tokens "
          f"{snap['prefix_cache']['cached_tokens']}), K4 launches {k4} = "
          f"{steps} x {L}")
    return reqs, k4, snap, wall


def phase_check(torch, model, reqs, attn):
    L = model.cfg.num_layers
    exact, min_margin, ties = 0, float("inf"), 0
    with torch.inference_mode():
        for r in reqs:
            ids = torch.from_numpy(r.output_ids).cuda()[None]
            logits = model(ids)[0].float()
            check(bool(torch.isfinite(logits).all()),
                  f"request {r.rid}: non-finite logits")
            n0 = len(r.prompt)
            lg = logits[n0 - 1:-1]
            top2 = lg.topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
            pred = lg.argmax(-1).cpu().numpy()
            gen = np.asarray(r.generated)
            bad = np.nonzero(pred != gen)[0]
            min_margin = min(min_margin, float(margin.min()))
            for i in bad:
                check(margin[i] < TIE_MARGIN,
                      f"request {r.rid} token {i}: engine {gen[i]} vs "
                      f"forward {pred[i]} at margin {margin[i]:.3e}")
            ties += len(bad)
            exact += not len(bad)
    k1 = attn.flash_attention_forward.launches
    check(k1 == len(reqs) * L, f"K1 launches {k1} != {len(reqs)} x {L}")
    print(f"  {exact}/{len(reqs)} streams match the teacher-forced forward "
          f"outright, {ties} tokens differ at near-ties (< {TIE_MARGIN}); "
          f"smallest top-2 margin {min_margin:.3e}; K1 launches {k1}")
    return k1


# ---------------------------------------------------------------- phase 6

def bwd_case(torch, attn, shape, causal, dtype, g):
    """q, k, v, dO in ``dtype`` on the card, with O and LSE from K1 and
    delta = rowsum(dO * O) in f32."""
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dt)
                   for _ in range(4))
    scale = 1.0 / shape[-1] ** 0.5
    o, lse = attn.flash_attention_forward(q, k, v, scale, causal)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    return q, k, v, do, lse, delta, scale


def bwd_check(torch, attn, shape, causal, dtype, g, errs):
    """One case of K2/K3 against the plain backward (phases 6 and 31c):
    f32 within BWD_F32_TOL of the largest grad; bf16 against P and dS
    kept f32 and against P and dS rounded to bf16 as the kernels round
    them, the latter's error into ``errs[(shape, causal, dtype, name)]``;
    a second run the same bits. Prints one line."""
    q, k, v, do, lse, delta, scale = bwd_case(torch, attn, shape, causal,
                                              dtype, g)
    args = (q, k, v, lse, do, delta, scale, causal)
    got = (attn.flash_bwd_dq(*args), *attn.flash_bwd_dkv(*args))
    # bf16: against P and dS kept f32 and against P and dS rounded to
    # bf16 as the kernels round them; the plain grads stay f32
    variants = ([(None, BWD_F32_TOL)] if dtype == "float32" else
                [(None, BWD_BF16_TOL), (torch.bfloat16, BWD_BF16P_TOL)])
    line = []
    for p_dtype, tol in variants:
        ref = attn.flash_attention_backward_plain(
            q.float(), k.float(), v.float(), lse, do.float(), delta,
            scale, causal, p_dtype=p_dtype)
        torch.cuda.synchronize()
        for name, a, want in zip(("dq", "dk", "dv"), got, ref):
            check(a.dtype == q.dtype and a.shape == want.shape,
                  f"K2/K3 {name} {shape}: dtype/shape")
            err = (a.float() - want).abs().max().item()
            top = want.abs().max().item()
            check(bool(torch.isfinite(a).all()) and err <= tol * top,
                  f"K2/K3 {name} {shape} causal={causal} {dtype} (P, dS "
                  f"{p_dtype or 'f32'}): max abs err {err} > {tol} x max "
                  f"|grad| {top}")
            # a row's error: against the plain version that rounds as
            # the kernel does
            if p_dtype is not None or dtype == "float32":
                errs[(shape, causal, dtype, name)] = err
            line.append(f"{name} err {err:.3e} vs P "
                        f"{'bf16' if p_dtype else 'f32'} (tol {tol} x "
                        f"max |grad| {top:.3e})")
    again = (attn.flash_bwd_dq(*args), *attn.flash_bwd_dkv(*args))
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K2/K3 {shape} causal={causal} {dtype}: two runs differ")
    line.append("a second run gives the same bits")
    print(f"  K2/K3 {list(shape)} causal={causal} {dtype}: "
          + "; ".join(line))


def phase_k2k3(torch, attn, train_shape):
    cases = [(train_shape, True, "float32"), (train_shape, True, "bfloat16"),
             ((1, 12, 333, 64), True, "float32"),
             ((1, 12, 333, 64), False, "float32"),
             ((1, 12, 333, 64), True, "bfloat16"),
             ((1, 12, 333, 64), False, "bfloat16"),
             ((1, 4, 200, 128), True, "float32"),
             ((1, 4, 200, 128), False, "bfloat16"),
             ((2, 3, 65, 128), True, "bfloat16"),
             (BERT_SHAPE, False, "float32"), (BERT_SHAPE, False, "bfloat16"),
             (BERT_CARD_SHAPE, False, "float32"),
             (ENCODER_SHAPE, False, "float32")]
    g = torch.Generator(device="cuda").manual_seed(6)
    errs = {}
    for shape, causal, dtype in cases:
        bwd_check(torch, attn, shape, causal, dtype, g, errs)

    return (flash_rows(torch, attn, train_shape, True, "float32", errs, g,
                       forward=False)
            + [row for shape, causal, dtype in (
                (train_shape, True, "bfloat16"),
                (BERT_SHAPE, False, "float32"),
                (BERT_CARD_SHAPE, False, "float32"),
                (BERT_SHAPE, False, "bfloat16"),
                (ENCODER_SHAPE, False, "float32"))
               for row in flash_rows(torch, attn, shape, causal, dtype, errs,
                                     g)])


def sdpa_backward_ms(torch, q, k, v, do, causal):
    """Device time of PyTorch's SDPA backward on (q, k, v, dO): one
    ``torch.autograd.grad`` of it captured in a CUDA graph, as
    ``torch.cuda.make_graphed_callables`` captures a backward (the forward
    runs on the capture stream, so its backward runs there too), and the
    replay timed. Timed through the autograd engine instead, the reading
    holds the engine's hand-off to its device thread: 0.05 and 0.40 ms in
    two runs at one shape while every kernel repeated within 2 %."""
    import torch.nn.functional as F
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        for _ in range(3):
            torch.autograd.grad(out, leaves, do, retain_graph=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        torch.autograd.grad(out, leaves, do, retain_graph=True)
    return time_ms(torch, graph.replay)


def flash_rows(torch, attn, shape, causal, dtype, errs, g, forward=True):
    """The kernels line's rows of K1 (with ``forward``), K2 and K3 at
    ``shape``, ``causal``, in ``dtype``: K1 held against its plain version
    (bf16: with P kept f32, and rounded to bf16 as the kernel rounds it,
    the row's error), each kernel timed against its plain version,
    PyTorch's SDPA forward and backward (device time, sdpa_backward_ms),
    and the bound of the work the inputs need: 4 d flops a query-key
    pair forward, over s (s + 1) / 2 pairs a row causal and s^2 not, and
    2.5 times that backward (K2 3 and K3 4 of the 5 products). K2/K3's
    errors are phase 6's readings at this case."""
    import torch.nn.functional as F
    q, k, v, do, lse, delta, scale = bwd_case(torch, attn, shape, causal,
                                              dtype, g)
    b, h, s, d = shape
    n = b * h * s
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    esz = 4 if dtype == "float32" else 2
    tag = f"{list(shape)} {'causal' if causal else 'non-causal'} {dtype}"
    rows = []

    def row(name, src, line, ms, plain, lib, bd, err):
        rows.append({"name": name, "route": "cuda", "dtype": dtype,
                     "shape": tag, "source": "paddle_tpu_torch/csrc/" + src,
                     "replaces": "paddle_tpu/ops/attention.py" + line,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bd[0], "bound_by": bd[1],
                     "library_ms": lib})

    def rate(name, ms, flops, bd):
        return (f"{name} {ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s, "
                f"{bd[0] / ms:.4f} of its bound {bd[0]:.4f} ms ({bd[1]})")

    if forward:
        o, _ = attn.flash_attention_forward(q, k, v, scale, causal)
        variants = ([(None, F32_FLASH_TOL, F32_FLASH_TOL)]
                    if dtype == "float32" else
                    [(None, BF16_TOL, FLASH_LSE_TOL),
                     (torch.bfloat16, BF16P_TOL, FLASH_LSE_TOL)])
        for p_dtype, tol, ltol in variants:
            ro, rlse = attn.flash_attention_plain(q, k, v, scale, causal,
                                                  p_dtype=p_dtype)
            eo = (o.float() - ro.float()).abs().max().item()
            el = (lse - rlse).abs().max().item()
            check(eo <= tol and el <= ltol,
                  f"K1 {tag} (P {p_dtype or 'f32'}): O err {eo} > {tol} or "
                  f"LSE err {el} > {ltol}")
            k1_err = max(eo, el)
            del ro, rlse
        del o
        k1_ms = time_ms(torch, lambda: attn.flash_attention_forward(
            q, k, v, scale, causal))
        k1_plain = time_ms(torch, lambda: attn.flash_attention_plain(
            q, k, v, scale, causal), iters=10)
        k1_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        k1_flops = 4 * d * pairs
        k1_b = bound(4 * n * d * esz + n * 4, k1_flops, dtype)
        print(f"  {tag}: {rate('K1', k1_ms, k1_flops, k1_b)}; sdpa "
              f"{k1_lib:.4f} ms ({k1_ms / k1_lib:.2f}x); err {k1_err:.3e}; "
              f"plain {k1_plain:.4f} ms")
        row("flash_attention_forward", "flash_fwd.cu", ":67", k1_ms,
            k1_plain, k1_lib, k1_b, k1_err)
    args = (q, k, v, lse, do, delta, scale, causal)
    dq_ms = time_ms(torch, lambda: attn.flash_bwd_dq(*args))
    dkv_ms = time_ms(torch, lambda: attn.flash_bwd_dkv(*args))
    lib_ms = sdpa_backward_ms(torch, q, k, v, do, causal)
    plain_ms = time_ms(torch, lambda: attn.flash_attention_backward_plain(
        *args), iters=10)
    reads = 4 * n * d * esz + 2 * n * 4          # q, k, v, dO; lse, delta
    k2_flops, k3_flops = 3 * 2 * d * pairs, 4 * 2 * d * pairs
    k2_b = bound(reads + n * d * esz, k2_flops, dtype)
    k3_b = bound(reads + 2 * n * d * esz, k3_flops, dtype)
    all_b = bound(reads + 3 * n * d * esz, 5 * 2 * d * pairs, dtype)
    print(f"  {tag}: {rate('K2', dq_ms, k2_flops, k2_b)}; "
          f"{rate('K3', dkv_ms, k3_flops, k3_b)}; K2 + K3 "
          f"{dq_ms + dkv_ms:.4f} ms against the backward's bound "
          f"{all_b[0]:.4f} ms ({all_b[1]}) and sdpa's backward "
          f"{lib_ms:.4f} ms ({(dq_ms + dkv_ms) / lib_ms:.2f}x); plain "
          f"backward {plain_ms:.4f} ms")
    key = (shape, causal, dtype)
    row("flash_bwd_dq", "flash_bwd.cu", ":200", dq_ms, plain_ms, lib_ms,
        k2_b, errs[key + ("dq",)])
    row("flash_bwd_dkv", "flash_bwd.cu", ":236", dkv_ms, plain_ms, lib_ms,
        k3_b, max(errs[key + ("dk",)], errs[key + ("dv",)]))
    return rows


# ------------------------------------------------------------ phases 7-8

def train_run(torch, cfg, optimizer, nn, clip):
    """TRAIN_STEPS f32 steps of ``GPTForCausalLM(cfg)`` from the same seeded
    weights, AdamW(1e-4, weight_decay 0.01), with ClipGradByGlobalNorm(1.0)
    when ``clip``: (losses, step ms, peak bytes, tokens a step)."""
    from paddle_tpu_torch.text.models import GPTForCausalLM
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).train()
    opt = optimizer.AdamW(1e-4, parameters=model.named_parameters(),
                          weight_decay=0.01,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0) if clip
                          else None)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, cfg.max_seq_len)).astype(np.int64)).cuda()
    labels = ids.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_run.held = torch.cuda.memory_allocated()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    del model, opt, loss
    return losses, times, peak, ids.numel()


def train_checked(torch, wrappers, want, cfg, optimizer, nn, clip):
    """One train_run with every wrapper's count set to 0 just before it
    and read just after: the loss finite and falling, the launches
    ``want``. Prints and returns (losses, step ms, peak bytes, tokens)."""
    for fn in wrappers:
        fn.launches = 0
    losses, times, peak, tokens = train_run(torch, cfg, optimizer, nn, clip)
    counts = tuple(fn.launches for fn in wrappers)
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(counts == want, f"launches {counts} != {want}")
    step_ms = float(np.median(times[1:]))
    print(f"  losses {[round(x, 6) for x in losses]}; step ms "
          f"{[round(t, 2) for t in times]}")
    print(f"  median step (steps 2-{TRAIN_STEPS}) {step_ms:.2f} ms, "
          f"{tokens / step_ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB; launches "
          + ", ".join(f"{fn.__name__} {n}" for fn, n in zip(wrappers,
                                                            counts)))
    return losses, times, peak, tokens


def phase_train(torch, attn, cfg, optimizer, nn):
    """Phase 7: ((K1, K2, K3) launches, (losses, step ms, peak bytes,
    bytes held when the peak was reset))."""
    L = cfg.num_layers
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv)
    losses, times, peak, _ = train_checked(
        torch, wrappers, (TRAIN_STEPS * L,) * 3, cfg, optimizer, nn, True)
    return tuple(fn.launches for fn in wrappers), (losses, times, peak,
                                                   train_run.held)


def phase_tied_f32(torch, attn, tce, cfg, optimizer, nn, _build, parent):
    """The flagship's step in f32 (phase 10 without auto_cast): the tied
    head through the f32 K5-K7 once a step. Where the parent's K5 was
    built, the same steps with it, in turns (this tree, the parent, the
    parent, this tree): the host's speed drifts within a call. Its sums
    run in another order, so every step's loss is held within LOSS_RTOL
    of the parent's, and the peak memory to the parent's + 64 MiB."""
    L = cfg.num_layers
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv, tce.fused_ce_forward, tce.fused_ce_bwd_dx,
                tce.fused_ce_bwd_dw)
    first = train_checked(torch, wrappers,
                          (TRAIN_STEPS * L,) * 3 + (TRAIN_STEPS,) * 3, cfg,
                          optimizer, nn, False)
    counts = tuple(fn.launches for fn in wrappers)
    losses, tokens = first[0], first[3]
    if not parent:
        return counts, first
    runs = {"this tree": [first[:3]], "the parent": []}
    for side in ("the parent", "the parent", "this tree"):
        with (parent_kernels(torch, _build, tce, parent)
              if side == "the parent" else contextlib.nullcontext()):
            runs[side].append(train_run(torch, cfg, optimizer, nn,
                                        False)[:3])
    (p_losses, _, _), _ = runs["the parent"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, p_losses)]
    med = {}
    for side, rs in runs.items():
        med[side] = float(np.median([t for _, ts, _ in rs for t in ts[1:]]))
        print(f"  {side}'s K5: step ms "
              + ", ".join(f"{[round(t, 2) for t in ts]}" for _, ts, _ in rs)
              + f"; median of steps 2-{TRAIN_STEPS} of both runs "
              f"{med[side]:.2f} ms, {tokens / med[side] * 1e3:.1f} "
              f"tokens/s; peak memory "
              + ", ".join(f"{pk / 2**30:.3f}" for _, _, pk in rs)
              + " GiB; the two runs' losses "
              + ("the same" if rs[0][0] == rs[1][0] else "differ"))
    print(f"  the parent's ({PARENT}) losses "
          f"{[round(x, 6) for x in p_losses]}; "
          f"relative differences {[float(f'{r:.3e}') for r in rel]}; "
          f"this tree's median step "
          f"{med['the parent'] - med['this tree']:.2f} ms shorter")
    check(max(rel) <= LOSS_RTOL, f"losses {losses} vs the parent's "
          f"{p_losses}")
    peaks = {side: max(pk for _, _, pk in rs) for side, rs in runs.items()}
    check(peaks["this tree"] <= peaks["the parent"] + (64 << 20),
          f"peak memory {peaks}")
    return counts, first


def phase_card_vs_cpu(torch, optimizer, nn, TransformerLMConfig, tie):
    from paddle_tpu_torch.text.models import GPTForCausalLM
    cfg = TransformerLMConfig(num_layers=2, tie_embeddings=tie,
                              dropout=0.0)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 256))
    runs = []
    for device in ("cpu", None):
        model = GPTForCausalLM(cfg, device=device,
                               generator=torch.Generator().manual_seed(7))
        opt = optimizer.AdamW(1e-4, parameters=model.named_parameters(),
                              weight_decay=0.01,
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        t = torch.from_numpy(ids.astype(np.int64)).to(model.device)
        losses, grads = [], None
        for step in range(3):
            loss = model(t, labels=t)
            loss.backward()
            if step == 0:
                grads = {n: p.grad.detach().float().cpu()
                         for n, p in model.named_parameters()}
            opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        runs.append((losses, grads))
    (cl, cg), (gl, gg) = runs
    rel = [abs(a - b) / abs(b) for a, b in zip(gl, cl)]
    check(max(rel) <= LOSS_RTOL, f"card losses {gl} vs CPU {cl}")
    worst, worst_name = 0.0, ""
    for name, want in cg.items():
        err = (gg[name] - want).abs().max().item()
        top = want.abs().max().item()
        r = err / max(top, 1e-30)
        check(r <= GRAD_TOL, f"step-1 grad {name}: max abs err {err} > "
              f"{GRAD_TOL} x max |grad| {top}")
        if r > worst:
            worst, worst_name = r, name
    print(f"  {'tied' if tie else 'untied'}: losses card {gl} vs CPU {cl}: "
          f"max rel diff {max(rel):.3e} "
          f"(tol {LOSS_RTOL}); step-1 grads of {len(cg)} parameters: "
          f"worst max|diff|/max|grad| {worst:.3e} at {worst_name} (tol "
          f"{GRAD_TOL})")


# ---------------------------------------------------------------- phase 9

def ce_case(torch, t, h, v, dtype, g):
    """x [t, h] ~ N(0, 1) (a LayerNorm output), W [v, h] ~ N(0, 0.02) (the
    embedding's init), int64 labels with about 5 % ignore_index, and a
    per-token cotangent of 1 / n_valid (the model's mean), on the card."""
    dt = getattr(torch, dtype)
    x = torch.randn(t, h, generator=g, device="cuda").to(dt)
    w = (torch.randn(v, h, generator=g, device="cuda") * 0.02).to(dt)
    labels = torch.randint(0, v, (t,), generator=g, device="cuda")
    labels[torch.rand(t, generator=g, device="cuda") < 0.05] = -100
    n_valid = int((labels != -100).sum())
    gg = torch.full((t,), 1.0 / max(n_valid, 1), device="cuda")
    return x, w, labels, gg


def parent_sources(parent_tree):
    """{source name: text} of the parent commit's ``csrc/fused_ce.cu`` (its
    f32 K5 is the port's first one): from ``--parent TREE``, a checkout of
    it, else from git history; None where neither is at hand."""
    names = sorted({name for name, _ in PARENT_SYMBOLS})
    out = {}
    for name in names:
        rel = f"paddle_tpu_torch/csrc/{name}.cu"
        if parent_tree:
            with open(os.path.join(parent_tree, rel)) as f:
                out[name] = f.read()
            continue
        if not os.path.isdir(os.path.join(HERE, ".git")):
            return None
        r = subprocess.run(["git", "show", f"{PARENT}:{rel}"], cwd=HERE,
                           capture_output=True, text=True, timeout=60)
        if r.returncode != 0:
            return None
        out[name] = r.stdout
    return out


def start_parent_build(_build, texts):
    """Start one ``nvcc`` per parent source into ``_build/parent/``;
    {name: (process, library path)}, or None without sources."""
    if texts is None:
        return None
    d = _build.BUILD_DIR / "parent"
    d.mkdir(parents=True, exist_ok=True)
    started = {}
    for name, text in texts.items():
        (d / f"{name}.cu").write_text(text)
        so = d / f"{name}.so"
        started[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(d / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    return started


def load_parent(started):
    """{(source, symbol): ctypes function} of the parent's K5, or None."""
    if started is None:
        return None
    libs = {}
    for name, (proc, so) in started.items():
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"the parent's {name}.cu did not build:"
              f"\n{out}")
        libs[name] = ctypes.CDLL(str(so))
    fns = {}
    for (name, sym), argtypes in PARENT_SYMBOLS.items():
        fn = getattr(libs[name], sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[(name, sym)] = fn
    return fns


@contextlib.contextmanager
def parent_kernels(torch, _build, tce, parent):
    """Inside this block the wrappers launch the parent's kernels of
    ``parent`` ({(source, symbol): ctypes function}, of this tree's C
    signatures): the functions they look up in ``_build`` are swapped,
    and so is the f32 K5's vocab split, which the parent's kernel counts
    in its own tiles; both are put back after."""
    saved = {key: _build._fns.get(key) for key in parent}
    split = tce._FWD_SPLIT[torch.float32]
    _build._fns.update(parent)
    tce._FWD_SPLIT[torch.float32] = PARENT_F32_SPLIT
    try:
        yield
    finally:
        tce._FWD_SPLIT[torch.float32] = split
        for key, fn in saved.items():
            if fn is None:
                del _build._fns[key]
            else:
                _build._fns[key] = fn


def phase_k5k7(torch, tce, t, h, v, _build, parent):
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(9)
    cases = [(t, h, v, "float32"), (t, h, v, "bfloat16"),
             (333, 768, 50304, "float32"), (333, 768, 50304, "bfloat16"),
             (1000, 200, 1234, "float32"), (1000, 200, 1234, "bfloat16"),
             (77, 800, 5000, "float32"), (77, 800, 5000, "bfloat16"),
             (33, 1536, 1234, "float32"), (1, 64, 7, "float32"),
             (1, 64, 7, "bfloat16"), (65, 13, 300, "float32"),
             (65, 13, 300, "bfloat16")]
    errs = {}
    for ct, ch, cv, dtype in cases:
        x, w, labels, gg = ce_case(torch, ct, ch, cv, dtype, g)
        loss, lse = tce.fused_ce_forward(x, w, labels)
        dx = tce.fused_ce_bwd_dx(x, w, labels, lse, gg)
        dw = tce.fused_ce_bwd_dw(x, w, labels, lse, gg)
        rloss, rlse = tce.fused_linear_cross_entropy_plain(
            x.float(), w.float(), labels)
        torch.cuda.synchronize()
        el = max((loss - rloss).abs().max().item(),
                 (lse - rlse).abs().max().item())
        check(el <= CE_LOSS_TOL, f"K5 [{ct},{ch},{cv}] {dtype}: loss/LSE err "
              f"{el} > {CE_LOSS_TOL}")
        errs[(ct, ch, cv, dtype, "loss")] = el
        line = [f"loss/LSE err {el:.3e}"]
        # bf16: against d kept f32 and against d rounded as the kernel does
        variants = ([(None, CE_F32_TOL)] if dtype == "float32" else
                    [(None, CE_BF16_TOL), (torch.bfloat16, CE_BF16D_TOL)])
        for d_dtype, tol in variants:
            ref = tce.fused_linear_cross_entropy_backward_plain(
                x.float(), w.float(), labels, lse, gg, d_dtype=d_dtype)
            for name, got, want in zip(("dx", "dW"), (dx, dw), ref):
                check(got.dtype == x.dtype and got.shape == want.shape,
                      f"K6/K7 {name}: dtype/shape")
                err = (got.float() - want).abs().max().item()
                top = want.abs().max().item()
                check(bool(torch.isfinite(got).all()) and err <= tol * top,
                      f"K6/K7 {name} [{ct},{ch},{cv}] {dtype} (d "
                      f"{d_dtype or 'f32'}): err {err} > {tol} x max |grad| "
                      f"{top}")
                line.append(f"{name} err {err:.3e} vs d "
                            f"{'bf16' if d_dtype else 'f32'} (tol {tol}, max "
                            f"|grad| {top:.3e})")
                errs[(ct, ch, cv, dtype, name)] = err
            del ref
        again = (*tce.fused_ce_forward(x, w, labels),
                 tce.fused_ce_bwd_dx(x, w, labels, lse, gg),
                 tce.fused_ce_bwd_dw(x, w, labels, lse, gg))
        check(all(torch.equal(a, b)
                  for a, b in zip(again, (loss, lse, dx, dw))),
              f"K5-K7 [{ct},{ch},{cv}] {dtype}: two runs differ")
        line.append("a second run gives the same bits")
        if parent and dtype == "float32":
            # the parent's K5 sums in another order: within CE_LOSS_TOL
            with parent_kernels(torch, _build, tce, parent):
                theirs = tce.fused_ce_forward(x, w, labels)
            e2 = max((a - b).abs().max().item()
                     for a, b in zip((loss, lse), theirs))
            check(e2 <= CE_LOSS_TOL, f"K5 [{ct},{ch},{cv}] f32: loss/LSE "
                  f"{e2} from the parent's")
            line.append(f"loss/LSE within {e2:.3e} of the parent's")
        print(f"  K5-K7 [T={ct}, H={ch}, V={cv}] {dtype}: " + "; ".join(line))

    # times at the flagship shape, in both dtypes: the f32 K5-K7 run on
    # phase 11's path, the bf16 ones on phase 10's. The f32 K5 is timed in
    # turns with the parent's (this tree, the parent, the parent, this
    # tree) where it was built
    flops = 2.0 * t * v * h
    rows = []
    for dtype in ("float32", "bfloat16"):
        x, w, labels, gg = ce_case(torch, t, h, v, dtype, g)
        loss, lse = tce.fused_ce_forward(x, w, labels)
        n6 = 30 if dtype == "bfloat16" else 5
        n5 = 30 if dtype == "bfloat16" else 10
        turns = {"this tree": [], "the parent": []}
        for side in (("this tree", "the parent", "the parent", "this tree")
                     if parent and dtype == "float32" else ("this tree",)):
            with (parent_kernels(torch, _build, tce, parent)
                  if side == "the parent" else contextlib.nullcontext()):
                turns[side].append(time_ms(
                    torch, lambda: tce.fused_ce_forward(x, w, labels),
                    iters=n5, warmup=3 if dtype == "bfloat16" else 1))
        k5 = float(np.median(turns["this tree"]))
        k6 = time_ms(torch, lambda: tce.fused_ce_bwd_dx(x, w, labels, lse,
                                                        gg),
                     iters=n6, warmup=3)
        k7 = time_ms(torch, lambda: tce.fused_ce_bwd_dw(x, w, labels, lse,
                                                        gg),
                     iters=n6, warmup=3)
        pf = time_ms(torch, lambda: tce.fused_linear_cross_entropy_plain(
            x, w, labels), iters=5, warmup=1)
        pb = time_ms(torch, lambda: tce.fused_linear_cross_entropy_backward_plain(
            x, w, labels, lse, gg), iters=5, warmup=1)
        leaves = [a.clone().requires_grad_() for a in (x, w)]

        def comp():
            return F.cross_entropy(F.linear(leaves[0], leaves[1]), labels,
                                   ignore_index=-100, reduction="none")
        cf = time_ms(torch, comp, iters=5, warmup=1)
        closs = comp()
        cb = time_ms(torch, lambda: torch.autograd.grad(
            closs, leaves, gg.to(closs.dtype), retain_graph=True),
            iters=5, warmup=1)
        del closs, leaves
        esz = x.element_size()
        ins = (t * h + v * h) * esz + t * 8
        b5 = bound(ins + 2 * t * 4, flops, dtype)
        b6 = bound(ins + 2 * t * 4 + t * h * esz, 2 * flops, dtype)
        b7 = bound(ins + 2 * t * 4 + v * h * esz, 2 * flops, dtype)
        rate = [f"{name} {ms:.3f} ms, {f / ms / 1e9:.1f} TFLOP/s, "
                f"{b[0] / ms:.4f} of its bound {b[0]:.4f} ms ({b[1]})"
                for name, ms, f, b in (("K5", k5, flops, b5),
                                       ("K6", k6, 2 * flops, b6),
                                       ("K7", k7, 2 * flops, b7))]
        print(f"  [T={t}, H={h}, V={v}] {dtype}: " + "; ".join(rate))
        print(f"  [T={t}, H={h}, V={v}] {dtype}: plain forward {pf:.3f} ms, "
              f"plain backward {pb:.3f} ms; composition yardstick "
              f"F.cross_entropy(F.linear) forward {cf:.3f} ms, backward (dx "
              f"and dW) {cb:.3f} ms")
        mine, theirs = turns["this tree"], turns["the parent"]
        if theirs:
            p_ms = float(np.median(theirs))
            print(f"  K5 {dtype} in turns: this tree "
                  f"{[round(m, 3) for m in mine]} ms ({b5[0] / k5:.4f} of "
                  f"its bound {b5[0]:.4f} ms), the parent's ({PARENT}) "
                  f"{[round(m, 3) for m in theirs]} ms "
                  f"({flops / p_ms / 1e9:.1f} TFLOP/s, {b5[0] / p_ms:.4f} "
                  f"of the bound): {p_ms / k5:.2f}x faster; the composition's "
                  f"forward {cf:.3f} ms")
            check(max(mine) < min(theirs), f"K5 {dtype}: this tree's "
                  f"{mine} ms not below the parent's {theirs}")
        # library_ms: the two-call composition F.cross_entropy(F.linear)
        for name, line, ms, plain_ms, lib_ms, (b_ms, b_by), key in (
                ("fused_ce_forward", ":93", k5, pf, cf, b5, "loss"),
                ("fused_ce_bwd_dx", ":183", k6, pb, cb, b6, "dx"),
                ("fused_ce_bwd_dw", ":198", k7, pb, cb, b7, "dW")):
            rows.append({"name": name, "route": "cuda", "dtype": dtype,
                         "source": "paddle_tpu_torch/csrc/fused_ce.cu",
                         "replaces": "paddle_tpu/ops/fused_ce.py" + line,
                         "max_abs_err": errs[(t, h, v, dtype, key)],
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms})
        del x, w, labels, gg, loss, lse
    return rows


# --------------------------------------------------------------- phase 10

def phase_flagship(torch, attn, tce, amp, optimizer, TransformerLMConfig,
                   recompute=False, steps=TRAIN_STEPS):
    """The reference's bench_gpt step (tools/baseline_bench.py:163-197),
    ``steps`` times from seeded weights, with per-block recompute when
    ``recompute`` (each block's K1 again in the backward). Returns the
    launches, the losses, the step ms and the peak bytes."""
    from paddle_tpu_torch.text.models import GPTForCausalLM
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv, tce.fused_ce_forward, tce.fused_ce_bwd_dx,
                tce.fused_ce_bwd_dw)
    cfg = TransformerLMConfig(dropout=0.0, use_flash_attention=True,
                              max_seq_len=FLAGSHIP["seq"],
                              recompute=recompute)
    L = cfg.num_layers
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).train()
    opt = optimizer.AdamW(1e-4, parameters=model.named_parameters(),
                          weight_decay=0.01)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (FLAGSHIP["batch"], FLAGSHIP["seq"])).astype(
            np.int64)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers:
        fn.launches = 0
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    counts = tuple(fn.launches for fn in wrappers)
    peak = torch.cuda.max_memory_allocated()
    check(loss.dtype == torch.float32, f"O1 loss dtype {loss.dtype}")
    del model, opt, loss
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = ((steps * L * (2 if recompute else 1),) + (steps * L,) * 2
            + (steps,) * 3)
    check(counts == want, f"K1/K2/K3/K5/K6/K7 launches {counts} != {want}")
    step_ms = float(np.median(times[1:]))
    tokens = ids.numel()
    print(f"  losses {[round(x, 6) for x in losses]}; step ms "
          f"{[round(t, 2) for t in times]}")
    print(f"  median step (steps 2-{steps}) {step_ms:.2f} ms, "
          f"{tokens / step_ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB; K1/K2/K3 launches {counts[:3]}, K5/K6/K7 "
          f"{counts[3:]} ({steps} steps x {L} layers"
          + (", K1 twice a block" if recompute else "") + ")")
    return counts, losses, times, peak


# --------------------------------------------------------------- phase 12

def optim_cases(optimizer, nn, regularizer):
    """(label, linear in the grad?, make(named parameters)) of phase 12,
    each at a learning rate that moves the 2-layer model in 3 steps."""
    O = optimizer
    return [
        ("SGD", True, lambda ps: O.SGD(0.1, parameters=ps)),
        ("Momentum(use_nesterov)", True, lambda ps: O.Momentum(
            0.05, parameters=ps, use_nesterov=True, weight_decay=0.01)),
        ("Adamax", False, lambda ps: O.Adamax(1e-3, parameters=ps)),
        ("Adagrad", False, lambda ps: O.Adagrad(1e-2, parameters=ps)),
        ("RMSProp(centered, momentum)", True, lambda ps: O.RMSProp(
            1e-4, parameters=ps, centered=True, momentum=0.9)),
        ("Lamb", False, lambda ps: O.Lamb(
            1e-3, parameters=ps,
            exclude_from_weight_decay_fn=lambda p: p.dim() == 1)),
        ("LarsMomentum", True, lambda ps: O.LarsMomentum(
            0.1, parameters=ps, exclude_from_weight_decay=["bias"])),
        ("Adadelta", True, lambda ps: O.Adadelta(1.0, parameters=ps)),
        ("Ftrl", False, lambda ps: O.Ftrl(1e-3, parameters=ps)),
        ("Adam(L1Decay, ClipGradByValue)", False, lambda ps: O.Adam(
            1e-4, parameters=ps, weight_decay=regularizer.L1Decay(1e-4),
            grad_clip=nn.ClipGradByValue(1e-3))),
        ("AdamW(param groups)", False, lambda ps: O.AdamW(
            1e-4, weight_decay=0.01,
            parameters=[{"params": ps[:8]}, {"params": ps[8:]}])),
    ]


def optim_run(model, init, make, ids, steps=OPTIM_STEPS):
    """``steps`` steps from the weights ``init``: (losses, the parameters
    on the CPU)."""
    model.load_state_dict(init)
    opt = make(list(model.named_parameters()))
    losses = []
    for _ in range(steps):
        loss = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses, {n: p.detach().cpu().clone()
                    for n, p in model.named_parameters()}


def moves_apart(torch, card, cpu, init, hidden):
    """Every element of the card's parameters within twice the largest
    move of the CPU's; returns the worst ratio of ||card - cpu|| to
    ||cpu - init|| over the parameters (the key third of each QKV bias
    left out of the norm), its parameter and the largest move."""
    scale = max((cpu[n] - init[n]).abs().max().item() for n in cpu)
    worst, where = 0.0, ""
    for n in cpu:
        a, b, a0 = card[n], cpu[n], init[n]
        el = (a - b).abs().max().item()
        check(el <= 2 * scale, f"{n}: an element {el} apart, past twice the "
              f"largest move {scale}")
        if n.endswith("attn.qkv.bias"):
            keep = torch.ones(a.numel(), dtype=torch.bool)
            keep[hidden:2 * hidden] = False
            a, b, a0 = a[keep], b[keep], a0[keep]
        move = (b - a0).norm().item()
        diff = (a - b).norm().item()
        r = diff / move if move else (float("inf") if diff else 0.0)
        if r >= worst:
            worst, where = r, n
    return worst, where, scale


def phase_optim(torch, wrappers, optimizer, nn, regularizer,
                TransformerLMConfig):
    from paddle_tpu_torch.text.models import GPTForCausalLM
    cfg = TransformerLMConfig(num_layers=2, dropout=0.0)
    L = cfg.num_layers
    ids_np = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 256))
    models = {dev: GPTForCausalLM(cfg, device=dev, generator=torch.Generator()
                                  .manual_seed(7)).train()
              for dev in ("cpu", None)}
    init = {k: v.clone() for k, v in models["cpu"].state_dict().items()}
    ids = {dev: torch.from_numpy(ids_np.astype(np.int64)).to(m.device)
           for dev, m in models.items()}
    for fn in wrappers:
        fn.launches = 0
    cases = optim_cases(optimizer, nn, regularizer)
    for label, linear, make in cases:
        (cl, cp), (gl, gp) = (optim_run(models[d], init, make, ids[d])
                              for d in ("cpu", None))
        rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
        check(all(np.isfinite(gl)) and rel <= LOSS_RTOL,
              f"{label}: card losses {gl} vs CPU {cl}")
        tol = OPT_LINEAR_TOL if linear else OPT_SIGN_TOL
        worst, where, scale = moves_apart(torch, gp, cp, init,
                                          cfg.hidden_size)
        check(worst <= tol, f"{label}: the card's move of {where} is "
              f"{worst:.3e} of the CPU's apart (tol {tol})")
        print(f"  {label}: losses card {[round(x, 6) for x in gl]}, max rel "
              f"diff {rel:.3e} (tol {LOSS_RTOL}); parameters moved up to "
              f"{scale:.3e}, card vs CPU at most {worst:.3e} of a tensor's "
              f"move ({where}; tol {tol})")

    # on the card: 4 straight steps against 2, a save, a fresh model and
    # optimizer loaded, 2 more
    card_ids = ids[None]

    def adamw(params):
        sched = optimizer.lr.CosineAnnealingDecay(1e-4, 4)
        return optimizer.AdamW(sched, parameters=params, weight_decay=0.01,
                               grad_clip=nn.ClipGradByGlobalNorm(1.0)), sched

    def steps(model, opt, sched, n):
        out = []
        for _ in range(n):
            loss = model(card_ids, labels=card_ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            sched.step()
            out.append(loss.item())
        return out

    card = models[None]
    card.load_state_dict(init)
    opt, sched = adamw(list(card.named_parameters()))
    straight = steps(card, opt, sched, 4)
    want = {n: p.detach().clone() for n, p in card.named_parameters()}
    card.load_state_dict(init)
    opt, sched = adamw(list(card.named_parameters()))
    first = steps(card, opt, sched, 2)
    saved_opt = opt.state_dict()
    saved = {k: v.clone() for k, v in card.state_dict().items()}
    fresh = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        99)).train()
    fresh.load_state_dict(saved)
    opt2, sched2 = adamw(list(fresh.named_parameters()))
    opt2.set_state_dict(saved_opt)
    resumed = first + steps(fresh, opt2, sched2, 2)
    differ = [n for n, p in fresh.named_parameters()
              if not torch.equal(p, want[n])]
    check(resumed == straight and not differ,
          f"resumed AdamW: losses {resumed} vs {straight}; parameters that "
          f"differ: {differ}")
    counts = tuple(fn.launches for fn in wrappers)
    n = OPTIM_STEPS * len(cases) + 4 + 2 + 2
    want_counts = (n * L,) * 3 + (n,) * 3
    check(counts == want_counts, f"phase 12 launches {counts} != "
          f"{want_counts}")
    print(f"  AdamW on the card: 2 steps, state_dict ({len(saved_opt) - 1} "
          f"tensors), a fresh model and optimizer loaded, 2 more steps: "
          f"the losses {resumed} and every parameter the bits of 4 straight "
          f"steps; launches K1/K2/K3 {counts[:3]}, K5/K6/K7 {counts[3:]} ({n}"
          f" steps x {L} layers)")
    del models, card, fresh, opt, opt2
    return counts


# --------------------------------------------------------------- phase 13

def phase_recompute(torch, wrappers, cfg, optimizer, nn, f32_run, amp, attn,
                    tce, TransformerLMConfig, flagship_losses):
    """Phase 11's step with recompute against phase 11's run ``f32_run``
    (losses, step ms, peak bytes, tokens), then 2 steps of phase 10's
    with recompute against ``flagship_losses``."""
    L = cfg.num_layers
    want = (2 * TRAIN_STEPS * L,) + (TRAIN_STEPS * L,) * 2 + (TRAIN_STEPS,) * 3
    losses, times, peak, tokens = train_checked(
        torch, wrappers, want, cfg, optimizer, nn, False)
    counts = tuple(fn.launches for fn in wrappers)
    ref_losses, ref_times, ref_peak, _ = f32_run
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    check(max(rel) <= RECOMPUTE_F32_RTOL, f"recompute losses {losses} vs "
          f"phase 11's {ref_losses}")
    check(peak < ref_peak, f"recompute peak {peak} not below phase 11's "
          f"{ref_peak}")
    ms, ref_ms = (float(np.median(t[1:])) for t in (times, ref_times))
    print(f"  against phase 11 (no recompute): losses within "
          f"{max(rel):.3e} relative (tol {RECOMPUTE_F32_RTOL}); peak "
          f"{peak / 2**30:.3f} GiB against {ref_peak / 2**30:.3f}; median "
          f"step {ms:.2f} ms against {ref_ms:.2f} ({ms / ref_ms:.3f}x)")
    bf_counts, bf_losses, _, _ = phase_flagship(
        torch, attn, tce, amp, optimizer, TransformerLMConfig,
        recompute=True, steps=2)
    rel = [abs(a - b) / abs(b) for a, b in zip(bf_losses, flagship_losses)]
    check(max(rel) <= RECOMPUTE_BF16_RTOL, f"O1 recompute losses {bf_losses}"
          f" vs phase 10's {flagship_losses[:2]}")
    print(f"  O1 bf16 with recompute: losses {bf_losses} within {max(rel):.3e}"
          f" relative of phase 10's first two (tol {RECOMPUTE_BF16_RTOL})")
    return counts, bf_counts


# --------------------------------------------------------------- phase 14

def first_divergence(a, b):
    """The first index where the token lists differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def phase_generate(torch, pa, attn, TransformerLMConfig):
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.text.models import GPTForCausalLM
    cfg = TransformerLMConfig(dropout=0.0)
    L = cfg.num_layers
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).eval()
    s0, n_new, b = 128, 96, 4
    prompts = np.random.RandomState(14).randint(0, cfg.vocab_size, (b, s0))
    ids = torch.from_numpy(prompts.astype(np.int64)).cuda()
    model.generate(ids[:, :16], max_new_tokens=4, temperature=0.0)  # warm-up
    torch.cuda.synchronize()
    pa.paged_decode_attention.launches = 0
    attn.flash_attention_forward.launches = 0
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=n_new, temperature=0.0)
    torch.cuda.synchronize()
    greedy_s = time.perf_counter() - t0
    check(out.dtype == torch.int64 and out.shape == (b, s0 + n_new)
          and out.device == model.device and torch.equal(out[:, :s0], ids),
          f"generate: {out.dtype} {tuple(out.shape)} on {out.device}")
    gen = out[:, s0:].cpu().numpy()
    with torch.inference_mode():
        lg = model(out[:, :-1])[:, s0 - 1:].float()
    check(bool(torch.isfinite(lg).all()), "non-finite teacher-forced logits")
    top2 = lg.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    pred = lg.argmax(-1).cpu().numpy()
    bad = np.argwhere(pred != gen)
    for r, i in bad:
        check(margin[r, i] < TIE_MARGIN, f"generate row {r} token {i}: "
              f"{gen[r, i]} vs forward {pred[r, i]} at margin "
              f"{margin[r, i]:.3e}")

    eng = ServingEngine(model, num_slots=8, block_size=16, async_depth=1)
    reqs = [eng.add_request(p, max_new_tokens=n_new) for p in prompts]
    eng.run()
    steps = eng.metrics.decode_steps
    k4 = pa.paged_decode_attention.launches
    check(k4 == steps * L, f"K4 launches {k4} != decode steps {steps} x {L}")
    same = 0
    for r, req in enumerate(reqs):
        i = first_divergence(req.generated, gen[r].tolist())
        check(len(req.generated) == n_new, f"request {req.rid} incomplete")
        if i is None:
            same += 1
            continue
        check(margin[r, i] < TIE_MARGIN, f"engine row {r} token {i}: "
              f"{req.generated[i]} vs generate {gen[r, i]} at margin "
              f"{margin[r, i]:.3e}")

    kw = dict(max_new_tokens=n_new, temperature=0.8, top_k=40, seed=1)
    t0 = time.perf_counter()
    drawn = model.generate(ids, **kw)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    check(torch.equal(drawn, model.generate(ids, **kw)),
          "top-k sampling: seed 1 twice gives other tokens")
    with torch.inference_mode():
        lg = model(drawn[:, :-1])[:, s0 - 1:].float()
    kth = lg.topk(40, dim=-1).values[..., -1]
    got = lg.gather(-1, drawn[:, s0:, None])[..., 0]
    check(bool((got >= kth - TIE_MARGIN).all()),
          "top-k sampling: a token outside the teacher-forced top 40")
    k1 = attn.flash_attention_forward.launches
    check(k1 == 2 * L, f"K1 launches {k1} != 2 forwards x {L}")

    cfg2 = TransformerLMConfig(num_layers=2, dropout=0.0)
    p2 = np.random.RandomState(15).randint(0, cfg2.vocab_size, (2, 64))
    beams = []
    for device in ("cpu", None):
        m2 = GPTForCausalLM(cfg2, device=device, generator=torch.Generator()
                            .manual_seed(7)).eval()
        t = torch.from_numpy(p2.astype(np.int64)).to(m2.device)
        if device is None:
            m2.generate(t, max_new_tokens=2, num_beams=4)        # warm-up
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        beams.append(m2.generate(t, max_new_tokens=32, num_beams=4).cpu())
        if device is None:
            torch.cuda.synchronize()
        beam_s = time.perf_counter() - t0
    check(torch.equal(beams[0], beams[1]), f"beam search: card "
          f"{beams[1][:, 64:].tolist()} vs CPU {beams[0][:, 64:].tolist()}")
    print(f"  greedy: {b} x {n_new} tokens in {greedy_s:.3f} s, "
          f"{b * n_new / greedy_s:.1f} generated tokens/s; "
          f"{len(bad)} tokens differ from the teacher-forced argmax at "
          f"near-ties (< {TIE_MARGIN}); smallest top-2 margin "
          f"{margin.min():.3e}; {same}/{b} engine streams identical to "
          f"generate()'s ({b - same} diverging at a near-tie); K4 launches "
          f"{k4} = {steps} x {L}")
    print(f"  top-k 40 at T 0.8: seed 1 twice the same tokens, each within "
          f"the teacher-forced top 40; {b * n_new / sample_s:.1f} generated "
          f"tokens/s; K1 launches {k1} (the two teacher-forced forwards)")
    print(f"  beam search (4 beams, batch 2, 32 new) on the 2-layer model: "
          f"card = CPU token for token; {2 * 32 / beam_s:.1f} generated "
          f"tokens/s on the card")
    del model
    return k1, k4


# --------------------------------------------------------------- phase 15

# 15d's sampled requests: every other one of the 16, seeds 0-7
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)


def request_kwargs(n, sampled):
    """Per-request add_request keywords: greedy, or with ``sampled`` the
    odd requests sampled at SAMPLED with seeds 0, 1, ..."""
    if not sampled:
        return [{} for _ in range(n)]
    return [dict(SAMPLED, seed=i // 2) if i % 2 else {} for i in range(n)]


def drive(eng, prompts, max_new, kws):
    """Phase 4's arrivals: eight requests, 24 steps, the other eight;
    returns the requests and the wall seconds (ending in a sync)."""
    import torch
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, max_new_tokens=n, **kw)
            for p, n, kw in zip(prompts[:8], max_new[:8], kws[:8])]
    for _ in range(24):
        eng.step()
    reqs += [eng.add_request(p, max_new_tokens=n, **kw)
             for p, n, kw in zip(prompts[8:], max_new[8:], kws[8:])]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r, n in zip(reqs, max_new):
        check(r.done and len(r.generated) == n,
              f"request {r.rid} incomplete: {len(r.generated)}/{n}")
    return reqs, wall


def same_stream(torch, model, prompt, got, want, kw):
    """Phase 5's rule: token for token, except that the streams may part
    at a token whose top-2 margin in the port's forward (over the prompt
    and the tokens both streams share) is below TIE_MARGIN; for a sampled
    request the margin is taken on the logits the sampling head draws
    from (scaled, masked, Gumbel noise added). Returns None when equal,
    else the margin where they part."""
    from paddle_tpu_torch.serving.sched.sampling import (gumbel_noise,
                                                         masked_logits)
    i = first_divergence(got, want)
    if i is None:
        check(len(got) == len(want), f"stream lengths {len(got)} vs "
              f"{len(want)}")
        return None
    ids = torch.from_numpy(np.concatenate(
        [prompt, np.asarray(want[:i], np.int64)])).to(model.device)[None]
    with torch.inference_mode():
        lg = model(ids)[0, -1:].float()
        if kw:
            dev = lg.device
            lg = masked_logits(
                lg, torch.tensor([kw["temperature"]], device=dev),
                torch.tensor([kw["top_k"]], device=dev),
                torch.tensor([kw["top_p"]], device=dev)) + gumbel_noise(
                torch.tensor([kw["seed"]], device=dev),
                torch.tensor([len(prompt) - 1 + i], device=dev),
                lg.shape[-1])
    top2 = lg[0].topk(2).values
    margin = float(top2[0] - top2[1])
    check(margin < TIE_MARGIN, f"streams part at token {i}: {got[i]} vs "
          f"{want[i]} at margin {margin:.3e}")
    return margin


def compare(torch, model, prompts, reqs, want, kws, label):
    """Every stream of ``reqs`` against ``want`` (token lists) under the
    margin rule; prints and returns the number that parted at a tie."""
    ties = [m for p, r, w, kw in zip(prompts, reqs, want, kws)
            if (m := same_stream(torch, model, p, r.generated, w, kw))
            is not None]
    print(f"    {label}: {len(reqs) - len(ties)}/{len(reqs)} streams equal"
          + (f", {len(ties)} parting at a near-tie (margins "
             f"{', '.join(f'{m:.2e}' for m in ties)})" if ties else ""))
    return len(ties)


def serve_case(torch, model, prompts, max_new, pa, label, kws=None,
               **knobs):
    """One main-path run of phase 15 with the K4 count set to 0 just
    before and read just after: on the paged pool K4 = 12 x the plain
    decode steps (verify steps attend without it), on the slot pool 0."""
    from paddle_tpu_torch.serving import ServingEngine
    L = model.cfg.num_layers
    kws = kws or [{} for _ in prompts]
    eng = ServingEngine(model, num_slots=8, block_size=16, **knobs)
    pa.paged_decode_attention.launches = 0
    reqs, wall = drive(eng, prompts, max_new, kws)
    k4 = pa.paged_decode_attention.launches
    M = eng.metrics
    plain = M.decode_steps - M.spec_verify_steps
    if eng.paged:
        eng.pool.check_conservation()
        check(eng.pool.live_blocks == 0, f"{label}: blocks leaked")
        check(k4 == plain * L and k4 > 0, f"{label}: K4 launches {k4} != "
              f"{plain} plain decode steps x {L}")
    else:
        check(k4 == 0, f"{label}: K4 launched {k4} times on the slot pool")
    return reqs, eng, k4, M.tokens_per_sec(), wall


def phase_rest(torch, pa, TransformerLMConfig, prompts, max_new, ref, tps4):
    """Phase 15, the rest of the serving engine on phase 4's GPT-124M
    (same seed, weights and 16 requests; ``ref`` phase 4's paged greedy
    streams, ``tps4`` its tokens/s): 15a the slot pool at both pipeline
    depths; 15b chunked prefill on both pools; 15c speculative decoding
    on both pools; 15d per-slot sampling on both pools, twice, chunked,
    and card against CPU on phase 8's 2-layer model; 15e a prefill-role
    engine exporting each prompt's KV through JSON into a decode-role
    engine. Returns the K4 launches of its paged runs."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.kv_wire import KVWireError
    from paddle_tpu_torch.text.models import GPTForCausalLM
    cfg = TransformerLMConfig(dropout=0.0)
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).eval()
    n = len(prompts)
    greedy = [{} for _ in range(n)]
    k4_total = 0

    def line(label, eng, tps, wall, k4, extra=""):
        print(f"  {label}: {eng.metrics.tokens_generated} tokens in "
              f"{wall:.3f} s, tokens/s {tps:.1f} (phase 4: {tps4:.1f}); "
              f"decode steps {eng.metrics.decode_steps}, K4 launches {k4}"
              + extra)

    print("  [15a] slot pool (paged=False, max_len=1024)")
    slot_ref = None
    for depth in (1, 0):
        reqs, eng, k4, tps, wall = serve_case(
            torch, model, prompts, max_new, pa, "15a", paged=False,
            max_len=1024, async_depth=depth)
        line(f"async_depth={depth}", eng, tps, wall, k4,
             f"; prefill groups {eng.metrics.prefill_group_hist}")
        compare(torch, model, prompts, reqs, ref, greedy, "vs phase 4")
        if depth == 1:
            slot_ref = [r.generated for r in reqs]
    print("  [15b] chunked prefill (prefill_chunk=128, "
          "prefill_token_budget=256)")
    for paged, want in ((False, slot_ref), (True, ref)):
        reqs, eng, k4, tps, wall = serve_case(
            torch, model, prompts, max_new, pa, "15b", paged=paged,
            max_len=1024, prefill_chunk=128, prefill_token_budget=256)
        k4_total += k4
        sch = eng.metrics.snapshot()["scheduler"]
        line("paged" if paged else "slot pool", eng, tps, wall, k4,
             f"; chunk dispatches {sch['prefill_chunks']} for "
             f"{sch['chunked_requests']} chunked requests")
        # on the paged pool a cached prefix shortens the tail to chunk
        long = sum(len(p) > 128 for p in prompts)
        check(0 < sch["chunked_requests"] <= long and (
            paged or sch["chunked_requests"] == long),
            f"15b: chunked requests {sch['chunked_requests']} of {long}")
        compare(torch, model, prompts, reqs, want, greedy,
                "vs the same pool unchunked")
    print("  [15c] speculative decoding (spec_k=4)")
    for paged in (False, True):
        reqs, eng, k4, tps, wall = serve_case(
            torch, model, prompts, max_new, pa, "15c", paged=paged,
            max_len=1024, speculative=True, spec_k=4)
        k4_total += k4
        sp = eng.metrics.snapshot()["perf"]["spec"]
        line("paged" if paged else "slot pool", eng, tps, wall, k4,
             f" (12 x {sp['fallback_steps']} plain steps; "
             f"{sp['verify_steps']} verify steps); drafted "
             f"{sp['drafted_tokens']}, accepted {sp['accepted_tokens']}, "
             f"acceptance rate {sp['acceptance_rate']}, tokens a slot-leg "
             f"{sp['effective_tokens_per_dispatch']}")
        check(sp["verify_steps"] > 0, "15c: no verify step ran")
        compare(torch, model, prompts, reqs, ref, greedy, "vs plain greedy")
    print(f"  [15d] sampling: 8 greedy, 8 sampled at {SAMPLED}, seeds 0-7")
    kws = request_kwargs(n, True)
    sampled = [i for i in range(n) if kws[i]]
    first = {}
    for paged, chunk in ((False, None), (True, None), (True, 128)):
        runs = []
        for _ in range(1 if chunk else 2):
            reqs, eng, k4, tps, wall = serve_case(
                torch, model, prompts, max_new, pa, "15d", kws, paged=paged,
                max_len=1024, sampling=True, prefill_chunk=chunk)
            k4_total += k4
            runs.append(reqs)
            line(("paged" if paged else "slot pool")
                 + (f", chunk {chunk}" if chunk else f", run {len(runs)}"),
                 eng, tps, wall, k4)
        compare(torch, model, [prompts[i] for i in range(n) if i % 2 == 0],
                [runs[0][i] for i in range(n) if i % 2 == 0],
                [ref[i] for i in range(n) if i % 2 == 0], greedy,
                "greedy rows vs phase 4")
        if len(runs) == 2:
            check(all(runs[0][i].generated == runs[1][i].generated
                      for i in sampled), "15d: a second run with the same "
                  "seeds drew other tokens")
            print("    sampled rows: the second run drew the same tokens, "
                  "bit for bit")
        if first:
            compare(torch, model, [prompts[i] for i in sampled],
                    [runs[0][i] for i in sampled],
                    [first["slot"][i].generated for i in sampled],
                    [kws[i] for i in sampled],
                    "sampled rows vs the slot pool's")
        else:
            first["slot"] = runs[0]
    cfg2 = TransformerLMConfig(num_layers=2, dropout=0.0)
    outs = {}
    for device in ("cpu", None):
        m2 = GPTForCausalLM(cfg2, device=device, generator=torch.Generator()
                            .manual_seed(7)).eval()
        eng = ServingEngine(m2, num_slots=8, block_size=16, device=device,
                            sampling=True)
        reqs = [eng.add_request(p, max_new_tokens=k, **kw)
                for p, k, kw in zip(prompts, max_new, kws)]
        eng.run()
        outs[device] = (m2, reqs)
    compare(torch, outs[None][0], prompts, outs[None][1],
            [r.generated for r in outs["cpu"][1]], kws,
            "2-layer model, card vs CPU, all 16 rows")
    del outs
    print("  [15e] disaggregation: role=prefill -> JSON -> role=decode")
    pe = ServingEngine(model, num_slots=8, block_size=16, max_len=1024,
                       role="prefill")
    de = ServingEngine(model, num_slots=8, block_size=16, max_len=1024,
                       role="decode")
    de.warmup_kv_handoff()
    pa.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    held = [pe.add_request(p, max_new_tokens=1, hold_kv=True)
            for p in prompts]
    dreqs, handoff_s, corrupt = {}, [], None
    while len(dreqs) < n:
        pe.step()
        for i, r in enumerate(held):
            if not r.done or i in dreqs:
                continue
            t1 = time.perf_counter()
            payload = json.loads(json.dumps(pe.export_kv(r.rid)))
            while de.pool.free_count == 0:
                de.step()
            dreqs[i] = de.import_kv(payload, max_new[i])
            handoff_s.append(time.perf_counter() - t1)
            corrupt = corrupt or payload
        de.step()
    de.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k4 = pa.paged_decode_attention.launches
    k4_total += k4
    check(k4 == de.metrics.decode_steps * cfg.num_layers and k4 > 0,
          f"15e: K4 launches {k4} != {de.metrics.decode_steps} x 12")
    reqs = [dreqs[i] for i in range(n)]
    for r, k in zip(reqs, max_new):
        check(r.done and len(r.generated) == k, f"15e: request {r.rid} "
              f"incomplete")
    for e in (pe, de):
        e.pool.check_conservation()
        check(e.pool.live_blocks == 0, "15e: blocks leaked")
    wire = pe.metrics.snapshot()["kv_wire"]
    ptoks = sum(len(p) for p in prompts)
    tps = de.metrics.tokens_per_sec()
    line("decode engine", de, tps, wall, k4,
         f"; {wire['exports']} handoffs, {wire['export_bytes']} wire bytes "
         f"= {wire['export_bytes'] / ptoks:.1f} a prompt token; handoff "
         f"(export, JSON both ways, import) {np.mean(handoff_s) * 1e3:.2f} "
         f"ms mean, {max(handoff_s) * 1e3:.2f} max")
    compare(torch, model, prompts, reqs, ref, greedy, "vs phase 4")
    # one flipped byte: refused, the pool as it was
    frame = corrupt["frames"][0]
    raw = bytearray(base64.b64decode(frame["k"]))
    raw[len(raw) // 2] ^= 0x01
    frame["k"] = base64.b64encode(bytes(raw)).decode()
    before = (de.pool.free_count, de.pool.free_blocks, de.pool.stats())
    try:
        de.import_kv(corrupt, 4)
        check(False, "15e: a corrupted payload was imported")
    except KVWireError as e:
        print(f"    a payload with one flipped byte: KVWireError ({e})")
    check((de.pool.free_count, de.pool.free_blocks, de.pool.stats())
          == before, "15e: the refused import changed the pool")
    de.pool.check_conservation()
    del model, pe, de
    return k4_total


# --------------------------------------------------------------- phase 16

def fleet_engine(model, rid, **knobs):
    """One replica of phase 16: phase 4's engine on the card, with its
    own replica id."""
    from paddle_tpu_torch.serving import ServingEngine
    return ServingEngine(model, paged=True, num_slots=8, block_size=16,
                         replica_id=rid, **knobs)


def settle(gw, label):
    """Wait for a live gateway's engine to go idle, then audit its pool
    under the gateway's lock: conserved, every slot free, no block
    referenced. Returns its decode steps."""
    deadline = time.monotonic() + 60.0
    while time.monotonic() < deadline:
        with gw._lock:
            if not gw.engine.pending:
                break
        time.sleep(0.005)
    with gw._lock:
        eng = gw.engine
        check(not eng.pending, f"{label}: {gw.replica_id} still busy")
        eng.pool.check_conservation()
        check(eng.pool.free_count == eng.config.num_slots
              and eng.pool.live_blocks == 0,
              f"{label}: {gw.replica_id}'s pool not empty")
        return eng.metrics.decode_steps


def phase_fleet(torch, pa, attn, TransformerLMConfig, prompts, max_new,
                ref, tps4, wall4):
    """Phase 16, the hardened engine and the router on phase 4's
    GPT-124M (same seed, weights and 16 requests; ``ref`` phase 4's
    streams, ``tps4``/``wall4`` its tokens/s and wall): 16a the router
    over two in-process replicas; 16b a replica killed mid-stream; 16c
    one engine under the default chaos plan, twice; 16d a forced wedge
    and the supervisor's restart; 16e one replica over HTTP on
    127.0.0.1. Every stream is held to phase 5's rule against phase 4's;
    K4 = 12 x the decode steps of each run's engines, the counts set to
    0 just before and read just after. Returns (K4, K1) launches."""
    from paddle_tpu_torch.serving.resilience import FaultPlan
    from paddle_tpu_torch.serving.router import (
        ROUTER_STATE_KEYS, EngineGateway, HTTPTransport, InProcessTransport,
        Router, RouterConfig)
    from paddle_tpu_torch.text.models import GPTForCausalLM
    cfg = TransformerLMConfig(dropout=0.0)
    L = cfg.num_layers
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).eval()
    n = len(prompts)
    greedy = [{} for _ in range(n)]
    k4_total = k1_total = 0
    router_cfg = dict(max_retries=4, backoff_base_s=0.001,
                      backoff_max_s=0.01, refresh_s=0.05, affinity=False)

    class Done:
        """A finished routed request in the Request's shape compare()
        reads."""
        def __init__(self, tokens):
            self.generated = tokens

    def route(router, idx):
        t0 = time.perf_counter()
        tickets = [router.submit(prompts[i], max_new[i]) for i in idx]
        results = [t.result(timeout=300.0) for t in tickets]
        wall = time.perf_counter() - t0
        for i, r in zip(idx, results):
            check(r["ok"] and len(r["tokens"]) == max_new[i],
                  f"routed request {i}: {r['reason']}, "
                  f"{len(r['tokens'])}/{max_new[i]} tokens")
        return results, wall

    print("  [16a] Router over two in-process replicas")
    gws = [EngineGateway(fleet_engine(model, f"r{i}")) for i in range(2)]
    try:
        router = Router([InProcessTransport(g) for g in gws],
                        config=RouterConfig(**router_cfg))
        pa.paged_decode_attention.launches = 0
        attn.flash_attention_forward.launches = 0
        results, wall = route(router, range(n))
        steps0 = sum(settle(g, "16a") for g in gws)
        state = router.state()
        check(tuple(sorted(state)) == tuple(sorted(ROUTER_STATE_KEYS)),
              f"16a: router state keys {sorted(state)}")
        share = {g.replica_id: sum(r["replica_id"] == g.replica_id
                                   for r in results) for g in gws}
        tokens = sum(len(r["tokens"]) for r in results)
        print(f"    {tokens} tokens in {wall:.3f} s: tokens/s "
              f"{tokens / wall:.1f} (phase 4: {tps4:.1f} busy, "
              f"{sum(max_new) / wall4:.1f} over its {wall4:.3f} s wall); "
              f"requests a replica {share}; decode steps {steps0}")
        compare(torch, model, prompts, [Done(r["tokens"]) for r in results],
                ref, greedy, "vs phase 4")
        router.close()
        # the same requests without the router's worker threads: from
        # this thread to the two gateways in turn, then to one alone
        for label, targets in (("two gateways, no router", gws),
                               ("one gateway, no router", gws[:1])):
            t0 = time.perf_counter()
            direct = [targets[i % len(targets)].submit(
                prompts[i], max_new_tokens=max_new[i]) for i in range(n)]
            for i, r in enumerate(direct):
                check(targets[i % len(targets)].wait(r, timeout=300.0),
                      f"16a: {label}: request {i} timed out")
            dwall = time.perf_counter() - t0
            print(f"    {label}: {tokens} tokens in {dwall:.3f} s, "
                  f"tokens/s {tokens / dwall:.1f}")
            compare(torch, model, prompts, direct, ref, greedy,
                    "vs phase 4")
        steps = sum(settle(g, "16a") for g in gws)
        k4 = pa.paged_decode_attention.launches
        k1_total += attn.flash_attention_forward.launches
        check(k4 == steps * L and k4 > 0,
              f"16a: K4 launches {k4} != {steps} decode steps x {L}")
        k4_total += k4
        fired = {g.replica_id: g.engine.health.summary()["detectors"]
                 for g in gws if g.engine.health.anomalies_total}
        print(f"    16a's decode steps {steps}, K4 launches {k4}; health "
              f"anomalies {fired or 'none'}")
    finally:
        for g in gws:
            g.close()

    gws = [EngineGateway(fleet_engine(model, f"r{i}")) for i in range(2)]
    try:
        print("  [16b] replica r0 killed mid-stream (fresh replicas)")
        router = Router([InProcessTransport(g) for g in gws],
                        config=RouterConfig(**router_cfg))
        victim, survivor = gws
        pa.paged_decode_attention.launches = 0
        attn.flash_attention_forward.launches = 0
        steps0 = [g.engine.metrics.decode_steps for g in gws]
        t0 = time.perf_counter()
        tickets = [router.submit(prompts[i], max_new[i]) for i in range(n)]
        deadline = time.monotonic() + 120.0
        streaming = 0
        while streaming < 2 and time.monotonic() < deadline:
            with victim._lock:
                streaming = sum(1 for r in victim.engine.scheduler.active
                                .values() if r.generated)
            time.sleep(0.001)
        check(streaming >= 2, "16b: r0 never streamed two requests")
        t_kill = time.perf_counter()
        victim.kill()
        kill_ms = (time.perf_counter() - t_kill) * 1e3
        results = [t.result(timeout=300.0) for t in tickets]
        done_s = time.perf_counter() - t_kill
        wall = time.perf_counter() - t0
        for i, r in enumerate(results):
            check(r["ok"] and len(r["tokens"]) == max_new[i],
                  f"16b: request {i} {r['reason']}")
        failovers = router._stats["failovers"]
        check(failovers >= 1, "16b: no failover")
        steps = victim.engine.metrics.decode_steps - steps0[0] \
            + settle(survivor, "16b") - steps0[1]
        k4 = pa.paged_decode_attention.launches
        k1_total += attn.flash_attention_forward.launches
        check(k4 == steps * L, f"16b: K4 launches {k4} != {steps} x {L}")
        k4_total += k4
        moved = [r for r in results if r["failovers"]]
        print(f"    killed r0 with {streaming} of its requests streaming; "
              f"kill() {kill_ms:.1f} ms; failovers {failovers} "
              f"({len(moved)} requests moved to r1); kill -> every request "
              f"done {done_s:.3f} s; whole run {wall:.3f} s; K4 launches "
              f"{k4}")
        compare(torch, model, prompts, [Done(r["tokens"]) for r in results],
                ref, greedy, "vs phase 4 (journal replay)")
        router.close()
    finally:
        for g in gws:
            g.close()

    print("  [16c] chaos: FaultPlan(seed=13) at DEFAULT_RATES, "
          "max_dispatch_retries=8")
    logs = []
    kws = [dict(on_token=lambda r, t: None) for _ in range(n)]
    for run in range(2):
        eng = fleet_engine(model, "c0", chaos=FaultPlan(seed=13),
                           max_dispatch_retries=8)
        pa.paged_decode_attention.launches = 0
        attn.flash_attention_forward.launches = 0
        reqs, wall = drive(eng, prompts, max_new, kws)
        k4 = pa.paged_decode_attention.launches
        k1_total += attn.flash_attention_forward.launches
        check(k4 == eng.metrics.decode_steps * L,
              f"16c: K4 launches {k4} != {eng.metrics.decode_steps} x {L}")
        k4_total += k4
        eng.pool.check_conservation()
        check(eng.pool.live_blocks == 0 and eng.pool.free_count == 8,
              "16c: pool not empty")
        res = eng.metrics.snapshot()["resilience"]
        log = eng.chaos.fault_log()
        logs.append(log)
        print(f"    run {run + 1}: {eng.metrics.tokens_generated} tokens in "
              f"{wall:.3f} s, tokens/s {eng.metrics.tokens_per_sec():.1f} "
              f"(phase 4: {tps4:.1f}); {len(log)} faults "
              f"{res['faults_injected']}, retries "
              f"{res['dispatch_retries']}, callback errors "
              f"{res['callback_errors']}, aborted {res['requests_aborted']};"
              f" K4 launches {k4}")
        check(res["requests_aborted"] == 0, "16c: a request was aborted")
        compare(torch, model, prompts, reqs, ref, greedy, "vs phase 4")
        eng.close()
    check(logs[0], "16c: the plan fired no fault")
    check(logs[0] == logs[1], "16c: the second run's fault log differs")
    print(f"    the second run's fault log equals the first's "
          f"({len(logs[0])} entries)")

    print("  [16d] supervisor: a wedged decode, queue_stall after 4 steps")
    eng = fleet_engine(model, "s0", supervisor=True,
                       supervisor_cooldown_s=0.0, max_dispatch_retries=1000,
                       health_detectors={"queue_stall": {"stall_steps": 4}})
    pa.paged_decode_attention.launches = 0
    attn.flash_attention_forward.launches = 0
    reqs = [eng.add_request(p, max_new_tokens=k)
            for p, k in zip(prompts, max_new)]
    for _ in range(12):
        eng.step()
    check(eng.health.report()["healthy"], "16d: unhealthy before the wedge")
    pool_bytes = eng.pool.kc.nbytes + eng.pool.vc.nbytes
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def wedged(*a, **k):
        raise RuntimeError("decode wedged")

    eng._decode_fn = wedged
    t0 = time.perf_counter()
    wedge_steps = 0
    while eng.supervisor.restarts == 0:
        eng.step()
        wedge_steps += 1
        check(wedge_steps < 50, "16d: the supervisor never restarted")
    restart_ms = (time.perf_counter() - t0) * 1e3
    during = eng.health.report()
    check(during["degraded"] and not during["healthy"],
          f"16d: after the restart health says {during['healthy']}, "
          f"degraded {during['degraded']}")
    eng.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    after = eng.health.report()
    check(eng.supervisor.restarts == 1,
          f"16d: {eng.supervisor.restarts} restarts")
    check(after["healthy"] and not after["degraded"],
          "16d: not healthy after the replay")
    k4 = pa.paged_decode_attention.launches
    k1_total += attn.flash_attention_forward.launches
    check(k4 == eng.metrics.decode_steps * L,
          f"16d: K4 launches {k4} != {eng.metrics.decode_steps} x {L}")
    k4_total += k4
    eng.pool.check_conservation()
    check(eng.pool.live_blocks == 0, "16d: blocks leaked")
    # the restart frees the old pool before it builds the new one: the
    # peak over the start stays below a second pool
    check(peak < pool_bytes,
          f"16d: peak {peak} over the start holds a second pool "
          f"({pool_bytes} bytes)")
    for r, k in zip(reqs, max_new):
        check(r.done and len(r.generated) == k, f"16d: request {r.rid} "
              f"incomplete")
    print(f"    wedged for {wedge_steps} steps ({restart_ms:.1f} ms) to the "
          f"restart; health during the replay: healthy {during['healthy']}"
          f", degraded {during['degraded']}; after: healthy "
          f"{after['healthy']}; restarts 1; peak memory over the start "
          f"{peak / 2**20:.1f} MiB (a pool is {pool_bytes / 2**20:.1f} "
          f"MiB); K4 launches {k4}")
    compare(torch, model, prompts, reqs, ref, greedy, "vs phase 4 "
            "(replayed)")
    eng.close()
    del eng

    print("  [16e] HTTP: EngineGateway.serve() on 127.0.0.1, a router "
          "over HTTPTransport")
    gw = EngineGateway(fleet_engine(model, "h0"))
    handle = gw.serve(port=0, addr="127.0.0.1")
    router = None
    try:
        router = Router([HTTPTransport(f"127.0.0.1:{handle.port}",
                                       replica_id="h0", timeout_s=300.0)],
                        config=RouterConfig(**router_cfg))
        pa.paged_decode_attention.launches = 0
        attn.flash_attention_forward.launches = 0
        idx = range(4)
        results, wall = route(router, idx)
        steps = settle(gw, "16e")
        k4 = pa.paged_decode_attention.launches
        k1_total += attn.flash_attention_forward.launches
        check(k4 == steps * L, f"16e: K4 launches {k4} != {steps} x {L}")
        k4_total += k4
        codes = {}
        for path in ("/metrics", "/debug/health"):
            with urllib.request.urlopen(handle.url + path,
                                        timeout=30.0) as resp:
                codes[path] = resp.status
        check(all(c == 200 for c in codes.values()), f"16e: {codes}")
        print(f"    4 requests over the wire in {wall:.3f} s; GET {codes};"
              f" K4 launches {k4}")
        compare(torch, model, [prompts[i] for i in idx],
                [Done(r["tokens"]) for r in results],
                [ref[i] for i in idx], greedy, "vs phase 4")
    finally:
        if router is not None:
            router.close()
        gw.close()
    check(handle.closed, "16e: the server is still up")
    del model
    return k4_total, k1_total


# --------------------------------------------------------------- phase 17

# phase 17's SLO targets and tenants, and the observatories on and off
OBS_SLO = dict(slo_ttft_ms=2000.0, slo_tpot_ms=50.0)
OBS_TENANTS = ("acme", "zeta", "ortho")
OBS_ON = dict(perf=True, cache_observatory=True, trace_spans=True,
              health=True, **OBS_SLO)
OBS_OFF = dict(perf=False, cache_observatory=False, trace_spans=False,
               health=False)
# the debug surface every replica answers over serve_metrics()
OBS_ROUTES = ("/metrics", "/metrics.json", "/debug", "/debug/state",
              "/debug/requests", "/debug/traces", "/debug/perf",
              "/debug/cache", "/debug/tenants", "/debug/health",
              "/debug/ledger")


def get_json(url):
    """(status, body): JSON bodies decoded, text ones as bytes."""
    with urllib.request.urlopen(url, timeout=30.0) as resp:
        body = resp.read()
        if "json" in resp.headers.get("Content-Type", ""):
            body = json.loads(body)
        return resp.status, body


def decode_kv_bytes(prompts, max_new, cfg, kv_bytes):
    """This script's reckoning of the K/V bytes the decode dispatches
    move: every request rides max_new - 1 decodes (no EOS; a max-token
    stop is known at dispatch), at cached lengths P .. P + max_new - 2;
    each reads its live K/V (length + 1 positions: K4 stops there) and
    writes one position."""
    nh = cfg.num_heads
    per_pos = 2 * cfg.num_layers * nh * (cfg.hidden_size // nh) * kv_bytes
    return sum((base + 2) * per_pos for p, n in zip(prompts, max_new)
               for base in range(len(p), len(p) + n - 1))


def obs_run(torch, model, prompts, max_new, knobs, poll_s=None):
    """Phase 4's arrivals on a fresh engine, every request tagged with
    one of three tenants. With ``poll_s`` the engine is served on
    127.0.0.1 and a FleetPoller scrapes it every ``poll_s`` seconds on
    its own thread while it serves; the engine then steps and takes
    requests under the lock its debug routes read under. Returns
    (engine, requests, wall, tokens/s, poller)."""
    import threading
    from paddle_tpu_torch.observability.fleet import FleetPoller
    eng = fleet_engine(model, "o0", **knobs)
    poller = None
    if poll_s is not None:
        lock = threading.Lock()
        step, add = eng.step, eng.add_request

        def locked_step():
            with lock:
                return step()

        def locked_add(*a, **k):
            with lock:
                return add(*a, **k)
        eng.step, eng.add_request = locked_step, locked_add
        handle = eng.serve_metrics(lock=lock)
        poller = FleetPoller([f"127.0.0.1:{handle.port}"],
                             interval_s=poll_s, timeout_s=5.0)
        poller.start()
    kws = [dict(tenant_id=OBS_TENANTS[i % 3]) for i in range(len(prompts))]
    try:
        reqs, wall = drive(eng, prompts, max_new, kws)
    finally:
        if poller is not None:
            poller.stop()
    return eng, reqs, wall, eng.metrics.tokens_per_sec(), poller


def phase_observe(torch, pa, attn, TransformerLMConfig, prompts, max_new,
                  ref, tps4):
    """Phase 17, the serving engine's observatories and the fleet
    telemetry on phase 4's GPT-124M (same seed, weights and 16 requests,
    spread over three tenants; ``ref`` phase 4's streams, ``tps4`` its
    tokens/s): 17a every observatory on changes no token; 17b the decode
    program's roofline floor against this script's reckoning, its
    roofline fraction, the MFU gauge and the HBM gauges; 17c tenants,
    SLO, flight recorder, traces, the cache section and every route; 17d
    two replicas over HTTP behind a FleetPoller and a FleetServer, one
    killed; 17e tokens/s with every observatory on and off in turns, and
    on with a poller scraping every 0.25 s. K4 = 12 x the decode steps
    of each run's engines, the counts set to 0 just before and read just
    after. Returns (K4, K1) launches."""
    from paddle_tpu_torch.observability.cache import CACHE_KEYS
    from paddle_tpu_torch.observability.fleet import (FleetPoller,
                                                      FleetServer)
    from paddle_tpu_torch.observability.perf import (PERF_KEYS,
                                                     PERF_SPEC_KEYS)
    from paddle_tpu_torch.observability.tenant import TENANT_KEYS
    from paddle_tpu_torch.observability.trace import TraceAssembler
    from paddle_tpu_torch.serving.router import EngineGateway
    from paddle_tpu_torch.text.models import GPTForCausalLM
    cfg = TransformerLMConfig(dropout=0.0)
    L = cfg.num_layers
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).eval()
    n = len(prompts)
    greedy = [{} for _ in range(n)]
    by_tenant = {t: sum(max_new[i] for i in range(n)
                        if OBS_TENANTS[i % 3] == t) for t in OBS_TENANTS}
    totals = {"k4": 0, "k1": 0}

    def start():
        pa.paged_decode_attention.launches = 0
        attn.flash_attention_forward.launches = 0

    def counted(label, engines):
        k4 = pa.paged_decode_attention.launches
        steps = sum(e.metrics.decode_steps for e in engines)
        totals["k1"] += attn.flash_attention_forward.launches
        check(k4 == steps * L and k4 > 0,
              f"{label}: K4 launches {k4} != {steps} decode steps x {L}")
        totals["k4"] += k4
        return k4

    print(f"  [17a] every observatory on: perf, cache, trace spans, SLO "
          f"{OBS_SLO}, tenants {OBS_TENANTS}")
    start()
    eng, reqs, wall, tps, _ = obs_run(torch, model, prompts, max_new,
                                      OBS_ON)
    k4 = counted("17a", [eng])
    eng.pool.check_conservation()
    check(eng.pool.live_blocks == 0 and eng.pool.free_count == 8,
          "17a: pool not empty")
    M = eng.metrics
    print(f"    {M.tokens_generated} tokens in {wall:.3f} s, tokens/s "
          f"{tps:.1f} (phase 4: {tps4:.1f}); decode steps "
          f"{M.decode_steps}, K4 launches {k4} = {M.decode_steps} x {L}")
    compare(torch, model, prompts, reqs, ref, greedy, "vs phase 4")

    print("  [17b] perf: the decode program against its roofline")
    rep = M.perf_report()
    check(set(rep) == set(PERF_KEYS)
          and set(rep["spec"]) == set(PERF_SPEC_KEYS),
          f"17b: perf keys {sorted(rep)}")
    dev = rep["device"]
    check(dev["device_peak"] and dev["device_hbm"]
          and dev["hbm_bps"] == HBM_BPS
          and dev["peak_flops"] == PEAK_FLOPS["bfloat16"],
          f"17b: device figures {dev}")
    dec = rep["programs"]["decode"]
    steps = M.decode_steps
    check(dec["dispatches"] == steps, f"17b: {dec['dispatches']} decode "
          f"dispatches timed, {steps} run")
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = n_params * eng.params["wemb"].element_size()
    kv = decode_kv_bytes(prompts, max_new, cfg, eng.pool.kc.element_size())
    mean_bytes = param_bytes + kv / steps
    floor_ms = mean_bytes / HBM_BPS * 1e3
    check(dec["bound"] == "hbm", f"17b: decode bound by {dec['bound']}")
    check(abs(dec["roofline_floor_ms"] - floor_ms) <= 2e-6,
          f"17b: decode floor {dec['roofline_floor_ms']} ms vs this "
          f"script's {floor_ms:.6f} ms")
    frac = dec["roofline_fraction"]
    check(frac is not None and 0 < frac <= 1,
          f"17b: decode roofline fraction {frac}")
    mfu = M.estimated_mfu()
    check(0 < mfu < 1, f"17b: estimated MFU {mfu}")
    print(f"    decode: {steps} dispatches, {dec['avg_ms']} ms each "
          f"(dispatch {dec['dispatch_s']} s + sync {dec['sync_s']} s in "
          f"all); {mean_bytes:.6e} B a dispatch ({n_params} f32 "
          f"parameters, {kv / steps:.6e} B of K/V); roofline floor "
          f"{dec['roofline_floor_ms']} ms (this script: {floor_ms:.6f} ms "
          f"at {HBM_BPS:.3e} B/s); roofline fraction {frac}")
    print(f"    attributed_fraction {rep['attributed_fraction']} of "
          f"{rep['step_total_s']} s of steps; estimated MFU {mfu:.3e} "
          f"(decode FLOPs against the bf16 peak; the engine serves f32)")
    for label, prog in sorted(rep["programs"].items()):
        if label != "decode":
            print(f"    {label}: {prog['dispatches']} dispatches, "
                  f"{prog['avg_ms']} ms each, floor "
                  f"{prog['roofline_floor_ms']} ms, fraction "
                  f"{prog['roofline_fraction']}, bound {prog['bound']}")
    torch.cuda.synchronize()
    fams = M.registry.snapshot()
    in_use = fams["serving_hbm_bytes_in_use"]["values"][""]
    free = fams["serving_hbm_bytes_free"]["values"][""]
    direct = torch.cuda.memory_allocated()
    block = 2 * eng.pool.kc[:, 0].nbytes
    total = torch.cuda.mem_get_info()[1]
    check(abs(in_use - direct) <= block, f"17b: HBM gauge {in_use} vs "
          f"memory_allocated {direct} (a pool block is {block} B)")
    check(abs(in_use + free - total) <= block,
          f"17b: in use {in_use} + free {free} != the card's {total}")
    print(f"    HBM gauges: in use {in_use / 2**20:.1f} MiB "
          f"(memory_allocated {direct / 2**20:.1f} MiB), free "
          f"{free / 2**30:.2f} GiB of {total / 2**30:.2f} GiB")

    print("  [17c] tenants, SLO, flight recorder, traces, cache, routes")
    snap = M.snapshot()
    rows = snap["tenants"]["tenants"]
    check(set(snap["tenants"]) == set(TENANT_KEYS)
          and set(rows) == set(OBS_TENANTS), f"17c: tenants {sorted(rows)}")
    got = {t: rows[t]["tokens_out"] for t in OBS_TENANTS}
    check(got == by_tenant and sum(got.values()) == M.tokens_generated,
          f"17c: tokens per tenant {got} vs {by_tenant}")
    slo = snap["slo"]
    violating = sum(1 for r in reqs if eng.request_trace(r.rid)
                    .events[-1].get("slo_violations"))
    check(slo["attained"] + violating == M.requests_completed == n,
          f"17c: attained {slo['attained']} + violating {violating} != "
          f"{M.requests_completed}")
    fl = eng.flight.state()
    check(fl["completed_kept"] == n and fl["active"] == 0,
          f"17c: flight recorder {fl}")
    handle = eng.serve_metrics()
    try:
        base = f"http://127.0.0.1:{handle.port}"
        codes = {route: get_json(base + route)[0] for route in OBS_ROUTES}
        check(all(c == 200 for c in codes.values()), f"17c: {codes}")
        _, body = get_json(base + "/debug/requests?tenant=zeta")
        want = {r.rid for r in reqs if r.tenant_id == "zeta"}
        check({t["rid"] for t in body["completed"]} == want
              and not body["active"], "17c: /debug/requests?tenant=zeta "
              "is not exactly zeta's requests")
        asm = TraceAssembler()
        asm.scrape(base)
        ids = asm.trace_ids()
        check(sorted(ids) == sorted(r.trace.trace_id for r in reqs),
              f"17c: {len(ids)} traces for {n} requests")
        for tid in ids:
            names = sorted(s["name"] for s in asm.assemble(tid).spans)
            check(names == ["prefill/compute", "prefill/queue"],
                  f"17c: trace {tid} has {names}")
        _, cache = get_json(base + "/debug/cache")
        check(set(cache) == set(CACHE_KEYS) and cache["mrc"]
              and cache["accesses"] > 0, f"17c: /debug/cache {cache}")
    finally:
        handle.close()
    print(f"    tokens per tenant {got} (sum {M.tokens_generated}); SLO "
          f"attained {slo['attained']}, violations {slo['violations']}, "
          f"goodput {slo['goodput_tokens']} of {slo['total_tokens']} "
          f"tokens; flight traces {fl['completed_kept']}; {len(ids)} "
          f"assembled traces, each prefill/queue + prefill/compute (a "
          f"monolithic request's segments); cache: {cache['accesses']} "
          f"block accesses, {cache['hits']} hits, MRC "
          f"{[(p['factor'], p['est_hit_rate']) for p in cache['mrc']]}; "
          f"{len(codes)} routes answer 200")
    eng.close()
    del eng

    print("  [17d] the fleet: two replicas over HTTP, a FleetPoller and a "
          "FleetServer, one replica killed")
    gws = [EngineGateway(fleet_engine(model, f"f{i}", **OBS_ON))
           for i in range(2)]
    server = None
    try:
        urls = [f"127.0.0.1:{g.serve().port}" for g in gws]
        start()
        t0 = time.perf_counter()
        sub = [gws[i % 2].submit(prompts[i], max_new_tokens=max_new[i],
                                 tenant_id=OBS_TENANTS[i % 3])
               for i in range(n)]
        for i, r in enumerate(sub):
            check(gws[i % 2].wait(r, timeout=300.0),
                  f"17d: request {i} timed out")
        wall = time.perf_counter() - t0
        for g in gws:
            settle(g, "17d")
        counted("17d", [g.engine for g in gws])
        compare(torch, model, prompts, sub, ref, greedy, "vs phase 4")
        clock = {"t": 0.0}
        poller = FleetPoller(urls, timeout_s=30.0, down_after=2,
                             clock=lambda: clock["t"])
        check(poller.poll_once() == [],
              "17d: a fleet detector fired on a healthy fleet")
        state = poller.snapshot()
        verdicts = {e["replica_id"]: (e["verdict"], e["healthy"])
                    for e in state["replicas"].values()}
        check(verdicts == {"f0": ("up", True), "f1": ("up", True)},
              f"17d: verdicts {verdicts}")
        fleet = state["fleet"]
        sums = {"tokens_generated": sum(g.engine.metrics.tokens_generated
                                        for g in gws),
                "requests_completed": sum(
                    g.engine.metrics.requests_completed for g in gws),
                "goodput_tokens": sum(g.engine.metrics.slo.goodput_tokens
                                      for g in gws)}
        check({k: fleet[k] for k in sums} == sums,
              f"17d: fleet sums {fleet} vs the replicas' {sums}")
        ftok = {t: e["tokens_out"]
                for t, e in fleet["tenants"]["tenants"].items()}
        check(ftok == by_tenant, f"17d: fleet tokens per tenant {ftok}")
        server = FleetServer(poller)
        fbase = f"http://127.0.0.1:{server.serve(poll=False).port}"
        fcodes = {r: get_json(fbase + r)[0] for r in (
            "/fleet/health", "/fleet/state", "/fleet/metrics",
            "/fleet/tenants")}
        check(all(c == 200 for c in fcodes.values()), f"17d: {fcodes}")
        print(f"    16 requests to two gateways in {wall:.3f} s; verdicts "
              f"{verdicts}; fleet sums {sums} = the replicas'; TTFT "
              f"p50/p99 {fleet['latency']['ttft']['p50_ms']}/"
              f"{fleet['latency']['ttft']['p99_ms']} ms from merged "
              f"buckets; decode roofline fraction (mean) "
              f"{fleet['roofline_fraction']}; /fleet routes {fcodes}")
        gws[1].kill()
        fired, seen = [], []
        for _ in range(poller.down_after):
            clock["t"] += 10.0
            fired += poller.poll_once()
            seen.append({e["replica_id"]: e["verdict"]
                         for e in poller.snapshot()["replicas"].values()})
        check(seen[-1] == {"f0": "up", "f1": "down"}
              and all(v["f1"] != "down" for v in seen[:-1]),
              f"17d: verdicts a cycle after the kill {seen}")
        # the reference's replica_flap fires on an up->down transition:
        # once, on the eviction cycle, naming the killed replica alone
        check(len(fired) == 1 and fired[0]["detector"] == "replica_flap"
              and fired[0]["replicas"] == ["f1"], f"17d: fired {fired}")
        print(f"    killed f1: verdicts a cycle {seen}; replica_flap once, "
              f"on the eviction cycle ({fired[0]['reason']}), none for f0")
    finally:
        if server is not None:
            server.close()
        for g in gws:
            g.close()

    print("  [17e] what the observatories cost: tokens/s on, off, off, "
          "on; then on, scraped every 0.25 s")
    rates = {"on": [], "off": []}
    for label in ("on", "off", "off", "on"):
        start()
        e, rq, w, t, _ = obs_run(torch, model, prompts, max_new,
                                 OBS_ON if label == "on" else OBS_OFF)
        counted(f"17e {label}", [e])
        compare(torch, model, prompts, rq, ref, greedy, f"17e {label}")
        rates[label].append(t)
        print(f"    {label}: tokens/s {t:.1f} ({w:.3f} s wall; phase 4: "
              f"{tps4:.1f})")
        e.close()
    start()
    e, rq, w, t, poller = obs_run(torch, model, prompts, max_new, OBS_ON,
                                  poll_s=0.25)
    counted("17e polled", [e])
    compare(torch, model, prompts, rq, ref, greedy, "17e polled")
    (st,) = poller.replicas
    check(st.polls >= 1 and st.failures == 0,
          f"17e: {st.polls} scrapes, {st.failures} failed")
    e.close()
    print(f"    on, scraped every 0.25 s: tokens/s {t:.1f} ({w:.3f} s "
          f"wall; {st.polls} scrapes, last {st.scrape_s * 1e3:.1f} ms); "
          f"on {[round(x, 1) for x in rates['on']]}, off "
          f"{[round(x, 1) for x in rates['off']]}, phase 4 {tps4:.1f}")
    del model
    return totals["k4"], totals["k1"]


# --------------------------------------------------------------- phase 18

# the router of phases 16 and 18 (no affinity: requests spread evenly)
ROUTER_CFG = dict(max_retries=4, backoff_base_s=0.001, backoff_max_s=0.01,
                  refresh_s=0.05, affinity=False)
# one replica process of phase 18: phase 4's model (its weights from the
# same seeded CPU generator) on ServingEngine(paged, num_slots=8,
# block_size=16)
DRILL_WORKER = dict(device="cuda", model="gpt", model_seed=1234,
                    num_slots=8, block_size=16)


class Routed:
    """A finished routed request in the Request's shape compare()
    reads."""

    def __init__(self, tokens):
        self.generated = tokens


def worker_counts(label, readings, L):
    """The K4 and K1 launches of replica processes, summed: each
    worker's reading (``/v1/counts``) holds K4 = its decode steps x L."""
    k4 = k1 = 0
    for rid, c in sorted(readings.items()):
        check(c["num_layers"] == L and c["k4"] == c["decode_steps"] * L,
              f"{label}: {rid}'s K4 launches {c['k4']} != its "
              f"{c['decode_steps']} decode steps x {L}")
        k4 += c["k4"]
        k1 += c["k1"]
    return k4, k1


def phase_drill(torch, pa, attn, TransformerLMConfig, prompts, max_new,
                ref, tps4):
    """Phase 18, the fleet over replica processes on phase 4's GPT-124M
    (its seed, weights and 16 requests; ``ref`` phase 4's streams,
    ``tps4`` its tokens/s): 18a the router drill over 3 replica
    processes with one SIGKILLed, 18b its disaggregated flavour with the
    prefill replica killed, 18c routed tokens/s over 2 processes against
    2 in-process replicas and one engine, 18d fleet_top over the 2
    processes, 18e the lock patrol armed over one in-process gateway.
    Every stream is held to phase 5's rule against phase 4's. Every
    worker's K4 = its decode steps x 12 (each reports its own counts);
    the parent's engines the same. Returns (K4, K1) launches."""
    import contextlib
    import io
    from paddle_tpu_torch.analysis import lock_patrol
    from paddle_tpu_torch.serving.router import (
        EngineGateway, HTTPTransport, InProcessTransport, Router,
        RouterConfig)
    from paddle_tpu_torch.text.models import GPTForCausalLM
    from paddle_tpu_torch.tools import fleet_top
    from paddle_tpu_torch.tools import router_drill as rd
    cfg = TransformerLMConfig(dropout=0.0)
    L = cfg.num_layers
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).eval()
    n = len(prompts)
    greedy = [{} for _ in range(n)]
    lists = [[int(t) for t in p] for p in prompts]
    tokens = sum(max_new)
    totals = {"k4": 0, "k1": 0}
    attn.flash_attention_forward.launches = 0

    def start():
        """Counts to 0 before a run; the parent's K1 launches so far (its
        stream checks' forwards) are banked first."""
        totals["k1"] += attn.flash_attention_forward.launches
        pa.paged_decode_attention.launches = 0
        attn.flash_attention_forward.launches = 0

    def counted(label, steps):
        """The parent's K4 launches since start() = steps x L."""
        k4 = pa.paged_decode_attention.launches
        check(k4 == steps * L, f"{label}: K4 launches {k4} != {steps} "
              f"decode steps x {L}")
        totals["k4"] += k4
        return k4

    ties = []

    def parity(i, got, want):
        margin = same_stream(torch, model, prompts[i], got, want, {})
        if margin is not None:
            ties.append(margin)
        return True

    for label, kill in (("18a", "replica"), ("18b", "prefill")):
        print(f"  [{label}] router_drill --kill {kill}: 3 replica processes"
              f" ({'1 prefill + 2 decode' if kill == 'prefill' else 'monolithic'}"
              f"), phase 4's 16 requests a wave")
        counts = {}
        ties.clear()
        start()
        t0 = time.perf_counter()
        lines = io.StringIO()
        try:
            failures, waves = rd.run_drill(
                replicas=3, prompts=lists, max_new=max_new, seed=5,
                kill=kill, parity=parity, counts=counts, timeout_s=600.0,
                out=lines, **DRILL_WORKER)
        finally:
            for line in lines.getvalue().splitlines():
                print(f"    drill: {line}")
        wall = time.perf_counter() - t0
        check(not failures, f"{label}: {failures}")
        w1, w2, w3 = (waves[k] for k in ("reference", "failover",
                                         "baseline_no_failover"))
        check(w2["ok"] == n and w2["shed"] == 0,
              f"{label}: {w2['ok']}/{n} completed, {w2['shed']} shed")
        if kill == "prefill":
            check(w1["handoffs"] > 0, f"{label}: no KV handoff")
        k4 = k1 = 0
        for wave, readings in counts.items():
            a, b = worker_counts(f"{label} {wave}", readings, L)
            k4, k1 = k4 + a, k1 + b
        totals["k4"] += k4
        totals["k1"] += k1
        print(f"    reference wave: {w1['ok']}/{n} in {w1['wall_s']} s, "
              f"tokens/s {w1['tokens'] / w1['wall_s']:.1f} (phase 4: "
              f"{tps4:.1f})" + (f"; handoffs {w1['handoffs']}, wire bytes "
                                f"{w1['wire_bytes']}" if kill == "prefill"
                                else ""))
        print(f"    failover wave: killed {w2['killed']}; {w2['ok']}/{n} "
              f"completed, lost {w2['lost']}, failovers {w2['failovers']}, "
              f"retries {w2['retries']}, traced failovers "
              f"{w2['traced_failovers']}, steady-state compiles "
              f"{w2['steady_state_compiles']} (the port builds no program "
              f"per shape); kill -> every request done "
              f"{w2['kill_to_done_s']} s" + (
                  f"; handoffs {w2['handoffs']}, handoff failures "
                  f"{w2['handoff_failures']}" if kill == "prefill" else ""))
        print(f"    no-failover baseline: killed {w3['killed']}, lost "
              f"{len(w3['lost'])} ({w3['ok']} completed); survivors clean "
              f"and conserved; workers' K4 launches {k4} (= their decode "
              f"steps x {L}); near-ties in the drill's own parity "
              f"{len(ties)}; {wall:.1f} s")
        compare(torch, model, prompts, [Routed(t) for t in w1["streams"]],
                ref, greedy, f"{label} reference wave vs phase 4")
        compare(torch, model, prompts, [Routed(t) for t in w2["streams"]],
                ref, greedy, f"{label} failover wave vs phase 4")

    print("  [18c] what processes buy: routed tokens/s over 2 replica "
          "processes, 2 in-process replicas (16a) and one engine, in turns")
    w = DRILL_WORKER
    procs = [rd.spawn(i, device=w["device"], model=w["model"],
                      seed=w["model_seed"], num_slots=w["num_slots"],
                      block_size=w["block_size"], paged=True, prefix="t")
             for i in range(2)]
    try:
        infos = [rd.ready(p) for p in procs]
        urls = [f"http://127.0.0.1:{i['port']}" for i in infos]

        def via_processes():
            for u in urls:
                rd.post(u, "/v1/counts", {"reset": True})
            router = Router([HTTPTransport(u, replica_id=i["replica_id"],
                                           timeout_s=300.0)
                             for u, i in zip(urls, infos)],
                            config=RouterConfig(**ROUTER_CFG))
            t0 = time.perf_counter()
            tickets = [router.submit(lists[i], max_new[i]) for i in range(n)]
            res = [t.result(timeout=300.0) for t in tickets]
            wall = time.perf_counter() - t0
            router.close()
            for i, r in enumerate(res):
                check(r["ok"] and len(r["tokens"]) == max_new[i],
                      f"18c: request {i} {r['reason']}")
            k4, _ = worker_counts("18c", {i["replica_id"]: rd.post(
                u, "/v1/counts") for u, i in zip(urls, infos)}, L)
            totals["k4"] += k4
            return [Routed(r["tokens"]) for r in res], wall

        def in_process():
            gws = [EngineGateway(fleet_engine(model, f"i{i}"))
                   for i in range(2)]
            try:
                router = Router([InProcessTransport(g) for g in gws],
                                config=RouterConfig(**ROUTER_CFG))
                start()
                t0 = time.perf_counter()
                tickets = [router.submit(prompts[i], max_new[i])
                           for i in range(n)]
                res = [t.result(timeout=300.0) for t in tickets]
                wall = time.perf_counter() - t0
                router.close()
                counted("18c", sum(settle(g, "18c") for g in gws))
                for i, r in enumerate(res):
                    check(r["ok"], f"18c: request {i} {r['reason']}")
                return [Routed(r["tokens"]) for r in res], wall
            finally:
                for g in gws:
                    g.close()

        def one_engine():
            eng = fleet_engine(model, "e0")
            start()
            t0 = time.perf_counter()
            reqs = [eng.add_request(p, max_new_tokens=k)
                    for p, k in zip(prompts, max_new)]
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counted("18c", eng.metrics.decode_steps)
            eng.close()
            return reqs, wall

        runs = {"processes": via_processes, "in-process": in_process,
                "one engine": one_engine}
        rates = {k: [] for k in runs}
        for label in ("processes", "in-process", "one engine", "one engine",
                      "in-process", "processes"):
            got, wall = runs[label]()
            rates[label].append(tokens / wall)
            print(f"    {label}: {tokens} tokens in {wall:.3f} s, tokens/s "
                  f"{tokens / wall:.1f} (phase 4: {tps4:.1f}; "
                  f"{tokens / wall / tps4:.2f}x)")
            compare(torch, model, prompts, got, ref, greedy,
                    f"18c {label} vs phase 4")
        print("    tokens/s " + "; ".join(
            f"{k} {[round(x, 1) for x in v]}" for k, v in rates.items())
            + f"; phase 4 {tps4:.1f}")

        print("  [18d] fleet_top over the 2 replica processes")
        targets = [u.replace("http://", "") for u in urls]

        def top():
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = fleet_top.main(targets + ["--interval", "0.05",
                                               "--timeout", "5"])
            return rc, out.getvalue(), err.getvalue()

        rc, out, err = top()
        check(rc == 0 and "2/2 up" in out, f"18d: fleet_top exit {rc} with "
              f"both up:\n{out}{err}")
        procs[1].kill()
        procs[1].wait(timeout=30)
        rc1, out1, err1 = top()
        check(rc1 == 1 and targets[1] in err1 and "1/2 up" in out1,
              f"18d: fleet_top exit {rc1} after the kill:\n{out1}{err1}")
        print(f"    both up: exit {rc} ({out.splitlines()[-1].split('  ')[0]}"
              f"); {infos[1]['replica_id']} killed: exit {rc1}, "
              f"{err1.strip().splitlines()[0]}")
    finally:
        rd.stop(procs)

    print("  [18e] the lock patrol armed over one in-process gateway: "
          "phase 4's 16 requests, off/armed/armed/off")
    rates = {"off": [], "armed": []}
    report = None
    for label in ("off", "armed", "armed", "off"):
        with (lock_patrol() if label == "armed"
              else contextlib.nullcontext()) as patrol:
            gw = EngineGateway(fleet_engine(model, "p0"))
            try:
                start()
                t0 = time.perf_counter()
                reqs = [gw.submit(prompts[i], max_new_tokens=max_new[i])
                        for i in range(n)]
                for i, r in enumerate(reqs):
                    check(gw.wait(r, timeout=300.0),
                          f"18e: request {i} timed out")
                wall = time.perf_counter() - t0
                counted("18e", settle(gw, "18e"))
            finally:
                gw.close()
            if patrol is not None:
                findings = patrol.findings()
                report = patrol.report()
                check(not findings, "18e: patrol findings "
                      f"{[f.to_dict() for f in findings]}")
        rates[label].append(tokens / wall)
        compare(torch, model, prompts, reqs, ref, greedy, f"18e {label}")
        print(f"    {label}: tokens/s {tokens / wall:.1f} ({wall:.3f} s; "
              f"phase 4: {tps4:.1f})")
    print(f"    patrol: {report['locks']} locks patrolled, "
          f"{report['acquires']} acquires, {report['edges']} order edges, "
          f"no finding (the gateway's lock across its dispatch is "
          f"DEFAULT_PATROL_ALLOW's one rule); tokens/s armed "
          f"{[round(x, 1) for x in rates['armed']]} against off "
          f"{[round(x, 1) for x in rates['off']]}")
    start()
    del model
    return totals["k4"], totals["k1"]


# --------------------------------------------------------------- phase 19

def phase_core(torch, attn, train_shape):
    """Phase 19, the Paddle-style eager core on the card: set_device,
    to_tensor and Place; a Paddle-style loss around the core's attention
    op at the training shape through K1 and, in backward(), K2/K3, held
    to the same computation in plain torch through the same kernels; a
    double grad and a gradient penalty through the core's ops against
    torch's autograd.grad; a PyLayer; no_grad; a double grad through the
    attention op (K2/K3's first order, the composition's second) against
    torch's double grad of the composition. Returns (K1, K2, K3)
    launches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as device_mod
    from paddle_tpu_torch.core import lazy
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv)

    def start():
        for w in wrappers:
            w.launches = 0

    def launches():
        return [w.launches for w in wrappers]

    def rel(a, b):
        a, b = a.detach(), b.detach()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    try:
        place = paddle.set_device("gpu")
        dev = paddle.resolve_device()
        t = paddle.to_tensor([1.0, 2.0])
        check(place == paddle.CUDAPlace(0) and paddle.get_device() == "gpu:0"
              and t.value.device == torch.device("cuda", 0)
              and t.place == paddle.CUDAPlace(0), f"19: to_tensor on "
              f"{t.value.device}, Place {t.place}")
        print(f"  set_device('gpu') -> {place}; to_tensor on "
              f"{t.value.device}, Place {t.place}")

        print(f"  [19a] a Paddle-style loss around the core's attention op "
              f"at {list(train_shape)} causal f32, backward() through K2/K3")
        g = torch.Generator().manual_seed(19)
        arrs = [torch.randn(train_shape, generator=g) * 0.5
                for _ in range(3)]
        w_np = torch.randn(train_shape[-1], generator=g).numpy()

        def core_loss():
            q, k, v = (paddle.to_tensor(a.numpy(), stop_gradient=False)
                       for a in arrs)
            out = attn.scaled_dot_product_attention(q, k, v, is_causal=True)
            w = paddle.to_tensor(w_np)
            loss = ((out * w).tanh().sum(axis=-1)
                    + out.square().mean(axis=-1) * 0.5).mean() \
                + paddle.logsumexp(out[:, :, -1], axis=-1).sum() * 1e-3
            return loss, (q, k, v)

        def torch_loss():
            q, k, v = (a.to(dev).requires_grad_() for a in arrs)
            out = attn.scaled_dot_product_attention(q, k, v, is_causal=True)
            w = torch.from_numpy(w_np).to(dev)
            loss = ((out * w).tanh().sum(-1)
                    + out.square().mean(-1) * 0.5).mean() \
                + torch.logsumexp(out[:, :, -1], dim=-1).sum() * 1e-3
            return loss, (q, k, v)

        start()
        loss, leaves = core_loss()
        loss.backward()
        lazy.flush()        # the step's graph runs (a step boundary)
        torch.cuda.synchronize()
        counts = launches()
        check(counts == [1, 1, 1], f"19a: K1/K2/K3 launches {counts}")
        tloss, tleaves = torch_loss()
        tloss.backward()
        exact = torch.equal(loss.value, tloss) and all(
            torch.equal(a.grad.value, b.grad)
            for a, b in zip(leaves, tleaves))
        errs = [rel(a.grad.value, b.grad) for a, b in zip(leaves, tleaves)]
        check(exact or max(errs) <= BWD_F32_TOL,
              f"19a: grads against plain torch {errs}")
        print(f"    loss {float(loss):.6f} (plain torch {tloss.item():.6f}); "
              f"grads of q, k, v {'bit for bit' if exact else errs} equal "
              f"to plain torch through the same kernels; K1/K2/K3 launches "
              f"{counts}")
        del leaves, tleaves, loss, tloss

        print("  [19b] paddle.grad(create_graph=True): a double grad and a "
              "gradient penalty through the core's ops")
        g = torch.Generator().manual_seed(20)
        x_np = torch.randn(256, 512, generator=g).numpy()
        w_np = (torch.randn(512, 64, generator=g) * 0.05).numpy()
        b_np = torch.randn(64, generator=g).numpy()
        x = paddle.to_tensor(x_np, stop_gradient=False)
        w, b = paddle.Parameter(w_np), paddle.Parameter(b_np)
        y = (paddle.matmul(x, w) + b).tanh()
        (gx,) = paddle.grad((y * y).sum(), x, create_graph=True)
        (gx * gx).mean().backward()
        tx, tw, tb = (torch.from_numpy(a).to(dev).requires_grad_()
                      for a in (x_np, w_np, b_np))
        ty = (tx @ tw + tb).tanh()
        (tgx,) = torch.autograd.grad((ty * ty).sum(), tx, create_graph=True)
        (tgx * tgx).mean().backward()
        errs = [rel(a, b_) for a, b_ in ((gx.value, tgx),
                                          (w.grad.value, tw.grad),
                                          (b.grad.value, tb.grad))]
        check(max(errs) <= 1e-5, f"19b: against torch.autograd {errs}")
        s = paddle.to_tensor(3.0, stop_gradient=False)
        (g1,) = paddle.grad(s ** 4, s, create_graph=True)
        (g2,) = paddle.grad(g1, s, create_graph=True)
        (g3,) = paddle.grad(g2, s)
        third = [float(v) for v in (g1, g2, g3)]
        check(third == [108.0, 108.0, 72.0], f"19b: x**4's grads {third}")
        print(f"    dL/dx, the penalty's grads of w and b against "
              f"torch.autograd.grad: largest relative differences {errs}; "
              f"x**4 at 3: {third}")

        print("  [19c] a PyLayer, and no_grad")

        class Double(paddle.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x):
                return x * 2

            @staticmethod
            def backward(ctx, grad):
                return grad * 2

        x = paddle.to_tensor([1.5, -2.0], stop_gradient=False)
        y = Double.apply(x)
        y.sum().backward()
        check(y.numpy().tolist() == [3.0, -4.0]
              and x.grad.numpy().tolist() == [2.0, 2.0]
              and y.value.is_cuda, f"19c: PyLayer {y.numpy()}, "
              f"{x.grad.numpy()}")
        with paddle.no_grad():
            z = x * 2
            inner = paddle.is_grad_enabled()
        check(z.stop_gradient and z.value.grad_fn is None and not inner
              and paddle.is_grad_enabled(), "19c: no_grad recorded")
        print("    PyLayer forward and backward on the card; no_grad "
              "records nothing")

        shape = (2, train_shape[1], 512, train_shape[-1])
        print(f"  [19d] a double grad through the attention op at "
              f"{list(shape)}: K2/K3's first order, the composition's "
              f"second, against torch's double grad of the composition")
        g = torch.Generator().manual_seed(21)
        arrs = [torch.randn(shape, generator=g) * 0.5 for _ in range(3)]
        start()
        q, k, v = (paddle.to_tensor(a.numpy(), stop_gradient=False)
                   for a in arrs)
        out = attn.scaled_dot_product_attention(q, k, v, is_causal=True)
        (gq,) = paddle.grad((out * out).sum() * 0.5, q, create_graph=True)
        pen = paddle.grad((gq * gq).sum(), [q, k, v])
        torch.cuda.synchronize()
        counts2 = launches()
        # K2/K3 twice: once for dL/dq (create_graph), once more as the
        # penalty's grad flows back through dO = out into the forward
        check(counts2 == [1, 2, 2], f"19d: K1/K2/K3 launches {counts2}")
        tq, tk, tv = (a.to(dev).requires_grad_() for a in arrs)
        sc = 1.0 / np.sqrt(shape[-1])
        tout = attn.reference_attention(tq, tk, tv, None, sc, True)
        (tgq,) = torch.autograd.grad((tout * tout).sum() * 0.5, tq,
                                     create_graph=True)
        tpen = torch.autograd.grad((tgq * tgq).sum(), [tq, tk, tv])
        errs = [rel(gq.value, tgq)] + [rel(a.value, b_)
                                       for a, b_ in zip(pen, tpen)]
        check(max(errs) <= BWD_F32_TOL, f"19d: against the composition "
              f"{errs}")
        print(f"    dL/dq and the penalty's grads of q, k, v within "
              f"{max(errs):.2e} of the composition's (tol {BWD_F32_TOL}); "
              f"K1/K2/K3 launches {counts2}")
        return tuple(a + b_ for a, b_ in zip(counts, counts2))
    finally:
        device_mod._current_place = None


# --------------------------------------------------------------- phase 20

def paddle_surface_gpt(paddle, cfg):
    """GPT-124M as a user writes it in the port's Paddle surface, the
    structure of the reference's paddle_tpu/text/models.py:58-215 (its
    structured names too): nn.Layer, word and position nn.Embedding, an
    nn.LayerList of pre-norm blocks with nn.LayerNorm, a fused-QKV
    nn.Linear split by paddle.reshape/transpose/unbind into
    nn.functional.scaled_dot_product_attention(is_causal=True), the
    output and fc1/fc2 nn.Linear with gelu(approximate=True), paddle.add
    for the residuals and an untied nn.Linear head into
    nn.functional.cross_entropy (the logits without labels). Dropout 0."""
    nn, F = paddle.nn, paddle.nn.functional

    class SelfAttention(nn.Layer):
        def __init__(self):
            super().__init__()
            h = cfg.hidden_size
            self.num_heads = cfg.num_heads
            self.head_dim = h // cfg.num_heads
            self.qkv = nn.Linear(h, 3 * h)
            self.out = nn.Linear(h, h)

        def forward(self, x):
            b, s, h = x.shape
            qkv = paddle.reshape(self.qkv(x),
                                 [b, s, 3, self.num_heads, self.head_dim])
            qkv = paddle.transpose(qkv, [2, 0, 3, 1, 4])
            q, k, v = paddle.unbind(qkv, axis=0)
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            o = paddle.reshape(paddle.transpose(o, [0, 2, 1, 3]), [b, s, h])
            return self.out(o)

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
            self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

        def forward(self, x):
            return self.fc2(F.gelu(self.fc1(x), approximate=True))

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(cfg.hidden_size)
            self.attn = SelfAttention()
            self.ln2 = nn.LayerNorm(cfg.hidden_size)
            self.mlp = MLP()

        def forward(self, x):
            x = paddle.add(x, self.attn(self.ln1(x)))
            return paddle.add(x, self.mlp(self.ln2(x)))

    class GPTModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word_embeddings = nn.Embedding(cfg.vocab_size,
                                                cfg.hidden_size)
            self.position_embeddings = nn.Embedding(cfg.max_seq_len,
                                                    cfg.hidden_size)
            self.blocks = nn.LayerList([Block()
                                        for _ in range(cfg.num_layers)])
            self.ln_f = nn.LayerNorm(cfg.hidden_size)

        def forward(self, ids):
            pos = paddle.arange(0, ids.shape[1], dtype="int64")
            x = paddle.add(self.word_embeddings(ids),
                           self.position_embeddings(pos))
            for blk in self.blocks:
                x = blk(x)
            return self.ln_f(x)

    class GPTForCausalLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.gpt = GPTModel()
            self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                     bias_attr=False)

        def forward(self, ids, labels=None):
            logits = self.lm_head(self.gpt(ids))
            if labels is None:
                return logits
            return F.cross_entropy(
                paddle.reshape(logits, [-1, cfg.vocab_size]),
                paddle.reshape(labels, [-1]))

    return GPTForCausalLM()


def host_us(torch, fn, n=400):
    """Host wall time of one call of ``fn``, in us: ``n`` calls, then a
    synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def phase_paddle_nn(torch, attn, cfg, optimizer, nn, phase7):
    """Phase 20, the Paddle ``nn`` surface on the card: phase 7's untied
    GPT-124M written in the port's Paddle surface (paddle_surface_gpt),
    its initial weights carried in from phase 7's seeded torch GPT
    (``text.convert``: each Linear weight transposed into [in, out]).
    20a: a transposed-and-unbound q/k/v launches K1; step 1's loss
    within LOSS_RTOL of phase 7's and every grad within GRAD_TOL of the
    torch GPT's (relative to the parameter's largest grad); 20b: three
    AdamW steps as phase 7's (ClipGradByGlobalNorm(1.0)), each loss
    within LOSS_RTOL of phase 7's at that step, each parameter's move
    within phase 12's L2 rule against the torch GPT's 3 steps, K1 = K2 =
    K3 = 12 launches a step, the step ms and peak memory beside phase
    7's; 20c: the core's host time an op against the same torch call;
    20d: Dropout's keep share, seeds, Linear's Xavier std on the card,
    torch's global RNG untouched. Returns the (K1, K2, K3) launches of
    20b's steps. ``phase7``: (losses, step ms, peak bytes, bytes held
    when its peak was reset). The torch GPT's grads and parameters that
    20a/20b compare with wait on the host, so that the surface's peak
    counts what phase 7's does: the bytes held before the steps (the
    model, and whatever earlier phases still hold) and the steps'
    own."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as device_mod
    from paddle_tpu_torch.text import convert
    from paddle_tpu_torch.text.models import GPTForCausalLM
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv)
    L, steps = cfg.num_layers, 3
    p7_losses, p7_times, p7_peak, p7_held = phase7
    F = paddle.nn.functional

    def start():
        for w in wrappers:
            w.launches = 0

    def launches():
        return tuple(w.launches for w in wrappers)

    try:
        paddle.set_device("gpu")
        ids_np = np.random.RandomState(0).randint(
            0, cfg.vocab_size, (8, cfg.max_seq_len)).astype(np.int64)

        # the torch GPT of phase 7, 3 of its steps: step 1's grads and
        # the parameters after 3 steps, to hold the surface's to
        tg = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
            1234)).train()
        init_np = convert.state_dict_to_paddle_tpu(tg.state_dict())
        init = {n: p.detach().cpu() for n, p in tg.named_parameters()}
        opt = optimizer.AdamW(1e-4, parameters=tg.named_parameters(),
                              weight_decay=0.01,
                              grad_clip=nn.ClipGradByGlobalNorm(1.0))
        tids = torch.from_numpy(ids_np).cuda()
        t_losses = []
        for step in range(steps):
            loss = tg(tids, labels=tids)
            loss.backward()
            if step == 0:
                t_grads = {n: p.grad.detach().cpu()
                           for n, p in tg.named_parameters()}
            opt.step()
            opt.clear_grad()
            t_losses.append(loss.item())
        t_after = {n: p.detach().cpu() for n, p in tg.named_parameters()}
        del tg, opt, loss
        torch.cuda.empty_cache()

        print("  [20a] a transposed-and-unbound q/k/v through the core's "
              "attention op; step 1 against phase 7")
        b, s, nh, hd = 8, cfg.max_seq_len, cfg.num_heads, \
            cfg.hidden_size // cfg.num_heads
        qkv = paddle.transpose(paddle.reshape(
            paddle.randn([b, s, 3 * nh * hd]), [b, s, 3, nh, hd]),
            [2, 0, 3, 1, 4])
        q, k, v = paddle.unbind(qkv, axis=0)
        start()
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        torch.cuda.synchronize()
        want, _ = attn.flash_attention_plain(q.value, k.value, v.value,
                                             hd ** -0.5, True)
        err = (o.value - want).abs().max().item()
        check(not q.value.is_contiguous() and launches() == (1, 0, 0)
              and err <= F32_FLASH_TOL, f"20a: q contiguous "
              f"{q.value.is_contiguous()}, launches {launches()}, max abs "
              f"err {err}")
        print(f"    q [{b}, {nh}, {s}, {hd}] a strided view: K1 launched "
              f"once, max abs err {err:.2e} against the plain forward")
        del qkv, q, k, v, o, want

        model = paddle_surface_gpt(paddle, cfg)
        names = list(model.state_dict())
        check(names == list(init_np), f"20: names {names[:4]} ... vs the "
              f"torch GPT's {list(init_np)[:4]} ...")
        check(model.set_state_dict(init_np) == [], "20: weights missing")
        p0 = model.gpt.blocks[0].attn.qkv.weight
        off = [n for n, p in model.named_parameters() if not p.value.is_cuda]
        check(not off and p0.shape == [cfg.hidden_size,
                                       3 * cfg.hidden_size],
              f"20: qkv weight {p0.shape}; parameters off the card {off}")
        model.train()
        popt = paddle.optimizer.AdamW(
            1e-4, parameters=model.parameters(), weight_decay=0.01,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
        ids = paddle.to_tensor(ids_np)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        losses, times, counts = [], [], []
        for step in range(steps):
            start()
            t0 = time.perf_counter()
            loss = model(ids, ids)
            loss.backward()
            if step == 0:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                grads = {n: p.grad.value.cpu() for n, p in
                         model.named_parameters()}
                worst, where = 0.0, ""
                for n, g in grads.items():
                    tw = t_grads[n]
                    if g.dim() == 2 and "embeddings" not in n:
                        tw = tw.t()
                    r = ((g - tw).abs().max()
                         / tw.abs().max().clamp_min(1e-30)).item()
                    check(r <= GRAD_TOL, f"20a: grad {n}: {r:.3e} of its "
                          f"largest (tol {GRAD_TOL})")
                    if r >= worst:
                        worst, where = r, n
                del grads
                t0 += time.perf_counter() - t1
            popt.step()
            popt.clear_grad()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
            counts.append(launches())
        peak = torch.cuda.max_memory_allocated()
        rel = [abs(a - b_) / abs(b_) for a, b_ in zip(losses, p7_losses)]
        print(f"    step 1: loss {losses[0]:.6f} (phase 7: "
              f"{p7_losses[0]:.6f}), rel diff {rel[0]:.3e} (tol "
              f"{LOSS_RTOL}); {len(t_grads)} grads against the torch GPT's:"
              f" worst max|diff|/max|grad| {worst:.3e} at {where} (tol "
              f"{GRAD_TOL})")
        check(rel[0] <= LOSS_RTOL, f"20a: loss {losses[0]} vs phase 7's "
              f"{p7_losses[0]}")

        print(f"  [20b] {steps} AdamW steps (ClipGradByGlobalNorm(1.0))")
        check(max(rel) <= LOSS_RTOL and all(np.isfinite(losses)),
              f"20b: losses {losses} vs phase 7's {p7_losses[:steps]}")
        check(max(abs(a - b_) / abs(b_) for a, b_ in
                  zip(t_losses, p7_losses)) <= LOSS_RTOL,
              f"20b: the torch GPT's rerun {t_losses} vs phase 7's "
              f"{p7_losses[:steps]}")
        check(all(c == (L, L, L) for c in counts),
              f"20b: launches a step {counts}, want ({L}, {L}, {L})")
        after = {n: (p.value.t() if p.value.dim() == 2
                     and "embeddings" not in n else p.value).detach()
                 for n, p in model.named_parameters()}
        mv, mv_where, scale = moves_apart(
            torch, {n: a.cpu() for n, a in after.items()}, t_after, init,
            cfg.hidden_size)
        check(mv <= OPT_SIGN_TOL, f"20b: the move of {mv_where} is "
              f"{mv:.3e} of the torch GPT's apart (tol {OPT_SIGN_TOL})")
        med = float(np.median(times[1:]))
        med7 = float(np.median(p7_times[1:]))
        tokens = ids_np.size
        print(f"    losses {[round(x, 6) for x in losses]} (phase 7: "
              f"{[round(x, 6) for x in p7_losses[:steps]]}; max rel diff "
              f"{max(rel):.3e}, tol {LOSS_RTOL}); parameters moved up to "
              f"{scale:.3e}, at most {mv:.3e} of a tensor's move from the "
              f"torch GPT's ({mv_where}; tol {OPT_SIGN_TOL})")
        print(f"    step ms {[round(t, 2) for t in times]}: median of steps "
              f"2-{steps} {med:.2f} ms ({tokens / med * 1e3:.1f} tokens/s) "
              f"against phase 7's {med7:.2f} ms; peak memory "
              f"{peak / 2**30:.3f} GiB, {(peak - held) / 2**30:.3f} over "
              f"the {held / 2**30:.3f} held before the steps, against "
              f"phase 7's {p7_peak / 2**30:.3f}, "
              f"{(p7_peak - p7_held) / 2**30:.3f} over "
              f"{p7_held / 2**30:.3f}; launches K1/K2/K3 a step "
              f"{counts[0]}")
        total = tuple(sum(c[i] for c in counts) for i in range(3))
        del model, popt, loss, after, t_after, init, t_grads
        torch.cuda.empty_cache()

        print("  [20c] the core's host time an op against the same torch "
              "call (small card tensors, in turns), on the immediate path "
              "(FLAGS_lazy_eager False); beside it the lazy executor's "
              "host time to record the op (the flag True)")
        g = torch.Generator().manual_seed(20)
        a_np, b_np = (torch.randn(64, 64, generator=g).numpy()
                      for _ in range(2))
        a, b_ = paddle.to_tensor(a_np), paddle.to_tensor(b_np)
        av, bv = a.value, b_.value
        lnw, lnb = paddle.ones([64]), paddle.zeros([64])
        lin = paddle.nn.Linear(64, 64)
        wv, bbv = lin.weight.value, lin.bias.value
        tF = torch.nn.functional
        pairs = [
            ("paddle.add", lambda: paddle.add(a, b_),
             lambda: torch.add(av, bv)),
            ("paddle.matmul", lambda: paddle.matmul(a, b_),
             lambda: torch.matmul(av, bv)),
            ("paddle.reshape", lambda: paddle.reshape(a, [32, 128]),
             lambda: av.reshape(32, 128)),
            ("nn.functional.layer_norm",
             lambda: F.layer_norm(a, 64, lnw, lnb),
             lambda: tF.layer_norm(av, (64,), lnw.value, lnb.value, 1e-5)),
            ("nn.Linear call", lambda: lin(a),
             lambda: torch.matmul(av, wv) + bbv),
        ]
        from paddle_tpu_torch.core import lazy

        def recorded(fn):
            # the lazy executor's host time to record one op (its graph
            # runs after the timing)
            us = host_us(torch, fn)
            lazy.flush()
            return us

        for name, core_fn, torch_fn in pairs:
            paddle.set_flags({"FLAGS_lazy_eager": False})
            try:
                core_fn(), torch_fn()
                runs = {"core": [], "torch": []}
                for side in ("core", "torch", "torch", "core"):
                    runs[side].append(host_us(
                        torch, core_fn if side == "core" else torch_fn))
            finally:
                paddle.set_flags({"FLAGS_lazy_eager": True})
            core_fn()
            lazy.flush()
            rec = [recorded(core_fn) for _ in range(2)]
            c, t_ = min(runs["core"]), min(runs["torch"])
            print(f"    {name}: core {c:.2f} us, torch {t_:.2f} us, the "
                  f"core's dispatch {c - t_:.2f} us an op (turns: core "
                  f"{[round(x, 2) for x in runs['core']]}, torch "
                  f"{[round(x, 2) for x in runs['torch']]}); lazily "
                  f"recorded {min(rec):.2f} us an op (turns "
                  f"{[round(x, 2) for x in rec]})")

        print("  [20d] randomness on the card")
        cuda_state = torch.cuda.get_rng_state()
        cpu_state = torch.random.get_rng_state()
        p = 0.1
        drop = paddle.nn.Dropout(p)
        x = paddle.ones([8, cfg.max_seq_len, cfg.hidden_size])
        paddle.seed(2020)
        m1 = drop(x).value != 0
        r1 = paddle.randn([1000]).value.clone()
        paddle.seed(2020)
        m2 = drop(x).value != 0
        r2 = paddle.randn([1000]).value
        n = m1.numel()
        keep = m1.float().mean().item()
        bound_keep = 6 * np.sqrt(p * (1 - p) / n)
        check(abs(keep - (1 - p)) <= bound_keep, f"20d: keep share {keep} "
              f"vs {1 - p} +- {bound_keep}")
        check(torch.equal(m1, m2) and torch.equal(r1, r2),
              "20d: the same seed gave another mask or randn")
        emb = paddle.nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                  padding_idx=0)
        ln = paddle.nn.LayerNorm(cfg.hidden_size)
        check(all(t.value.is_cuda for t in (emb.weight, ln.weight, ln.bias))
              and not emb.weight.value[0].any(), "20d: Embedding's padding "
              "row or LayerNorm's parameters not on the card, or not zero")
        fc = paddle.nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        std = fc.weight.value.std().item()
        want_std = np.sqrt(2.0 / (cfg.hidden_size + cfg.intermediate_size))
        check(fc.weight.value.is_cuda and abs(std / want_std - 1) <= 0.01,
              f"20d: Linear std {std} vs Xavier {want_std}")
        check(torch.equal(torch.cuda.get_rng_state(), cuda_state)
              and torch.equal(torch.random.get_rng_state(), cpu_state),
              "20d: torch's global RNG state moved")
        print(f"    Dropout({p}) keep share {keep:.6f} over {n} elements "
              f"(1 - p = {1 - p}, 6-sigma bound {bound_keep:.2e}); the "
              f"same paddle.seed gives the same mask and randn; "
              f"Linear({cfg.hidden_size}, {cfg.intermediate_size}) weight "
              f"std {std:.6f} against Xavier's {want_std:.6f} (bound 1 %);"
              f" Embedding's padding row (zero) and LayerNorm's weight "
              f"and bias made on the card; torch's global CUDA and CPU RNG "
              f"states unchanged")
        return total
    finally:
        device_mod._current_place = None


# --------------------------------------------------------------- phase 21

def bert_data(b, seq, vocab):
    """bench_bert's batch (tools/baseline_bench.py:108-115): ids, zero
    token types, MLM labels at 15 % (-1 elsewhere), NSP labels [b, 1],
    from RandomState(0)."""
    rs = np.random.RandomState(0)
    ids = rs.randint(0, vocab, (b, seq)).astype("int64")
    tok = np.zeros((b, seq), "int64")
    mlm = np.where(rs.rand(b, seq) < 0.15,
                   rs.randint(0, vocab, (b, seq)), -1).astype("int64")
    nsp = rs.randint(0, 2, (b, 1)).astype("int64")
    return ids, tok, mlm, nsp


def rel_grads(torch, got, want, tol, label, noise=()):
    """Every grad of ``want`` within ``tol`` of its largest element (no
    check for ``tol=None``); the grads named in ``noise`` (a true grad
    of 0, rounding noise on both sides: MultiHeadAttention's key bias)
    within ``tol`` of the largest grad of all. Returns the worst ratio
    and its parameter."""
    worst, where = 0.0, ""
    top = max(w.abs().max().item() for w in want.values())
    for n, w in want.items():
        scale = top if n in noise else w.abs().max().clamp_min(1e-30)
        r = ((got[n].double() - w.double()).abs().max() / scale).item()
        check(tol is None or r <= tol, f"{label}: grad {n}: {r:.3e} of "
              f"its largest (tol {tol})")
        if r >= worst:
            worst, where = r, n
    return worst, where


def phase_bert(torch, attn, amp, optimizer):
    """Phase 21: BERT-base pretraining and the Paddle surface's part B on
    the card. 21a the masked attention route; 21b the reference's config
    3 (bench_bert) eager; 21c card against CPU on 2 layers at full
    width; 21d the TransformerEncoder at BERT-base width; 21e sparse
    embedding grads; 21f linalg. Returns the (K1, K2, K3) launches of
    21b (bf16 at BERT_SHAPE), 21c's card side (f32, [2,12,128,64]) and
    21d's steps (f32 at ENCODER_SHAPE)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as device_mod
    from paddle_tpu_torch.text.models import (BertForPretraining,
                                              TransformerLMConfig, bert_base)
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv)

    def start():
        for w in wrappers:
            w.launches = 0

    def launches():
        return tuple(w.launches for w in wrappers)

    print("  [21a] a masked attention on the card is the reference's "
          "composition")
    g = torch.Generator(device="cuda").manual_seed(21)
    q, k, v = (torch.randn(BERT_SHAPE, generator=g, device="cuda")
               for _ in range(3))
    s = BERT_SHAPE[2]
    fmask = torch.where(torch.rand((BERT_SHAPE[0], 1, 1, s), generator=g,
                                   device="cuda") < 0.9, 0.0, -1e9)
    bmask = torch.rand((1, 1, s, s), generator=g, device="cuda") < 0.8
    for label, mask in (("float", fmask), ("bool", bmask)):
        start()
        got = attn.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        core = paddle.nn.functional.scaled_dot_product_attention(
            *(paddle.Tensor._wrap(t) for t in (q, k, v)),
            attn_mask=paddle.Tensor._wrap(mask))
        want = attn.reference_attention(q, k, v, mask, 0.125, False)
        check(torch.equal(got, want) and torch.equal(core.value, want)
              and launches() == (0, 0, 0),
              f"21a: {label} mask: launches {launches()}, SDPA equal "
              f"{torch.equal(got, want)}, core op equal "
              f"{torch.equal(core.value, want)}")
        print(f"    {label} mask on {list(BERT_SHAPE)}: SDPA and the core "
              f"op give reference_attention's bits, K1 launched 0 times")
    del q, k, v, got, core, want

    print("  [21b] BERT-base pretraining (the reference's config 3, "
          "bench_bert), eager, AMP O1 bf16")
    steps = 8
    model = bert_base(max_seq_len=BERT["seq"], dropout=0.0,
                      generator=torch.Generator().manual_seed(0)).train()
    cfg = model.cfg
    L = cfg.num_layers
    n_params = sum(p.numel() for p in model.parameters())
    opt = optimizer.AdamW(1e-4, parameters=model.named_parameters(),
                          weight_decay=0.01)
    batch = [torch.from_numpy(a).cuda() for a in
             bert_data(BERT["batch"], BERT["seq"], cfg.vocab_size)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    losses, times, counts = [], [], []
    for _ in range(steps):
        start()
        t0 = time.perf_counter()
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model(*batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        counts.append(launches())
    peak = torch.cuda.max_memory_allocated()
    check(loss.dtype == torch.float32, f"21b: O1 loss dtype {loss.dtype}")
    del model, opt, loss, batch
    torch.cuda.empty_cache()
    check(all(np.isfinite(losses)), f"21b: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"21b: loss did not fall: {losses}")
    check(all(c == (L, L, L) for c in counts),
          f"21b: K1/K2/K3 launches a step {counts}, want ({L}, {L}, {L})")
    step_ms = float(np.median(times[1:]))
    samples = BERT["batch"] / step_ms * 1e3
    print(f"    {n_params / 1e6:.2f} M parameters, batch {BERT['batch']} x "
          f"{BERT['seq']}; losses {[round(x, 6) for x in losses]}; step ms "
          f"{[round(t, 2) for t in times]}")
    print(f"    median step (steps 2-{steps}) {step_ms:.2f} ms, "
          f"{samples:.1f} samples/s, {samples * BERT['seq']:.1f} tokens/s; "
          f"peak memory {peak / 2**30:.3f} GiB, "
          f"{(peak - held) / 2**30:.3f} over the {held / 2**30:.3f} held "
          f"before the steps; K1/K2/K3 launches {counts[0]} a step")
    bert_counts = tuple(sum(c[i] for c in counts) for i in range(3))

    print("  [21c] card against CPU: a 2-layer BertForPretraining at full "
          "width (768, 12 heads, vocab 30522), [2, 128], f32")
    small = TransformerLMConfig(vocab_size=30522, hidden_size=768,
                                num_layers=2, num_heads=12,
                                max_seq_len=BERT["seq"], dropout=0.0)
    data = bert_data(2, BERT["seq"], small.vocab_size)
    runs = []
    for device in ("cpu", "cuda"):
        m = BertForPretraining(small, device=device,
                               generator=torch.Generator().manual_seed(7))
        init = {n: p.detach().float().cpu().clone()
                for n, p in m.named_parameters()}
        o = optimizer.AdamW(1e-4, parameters=m.named_parameters(),
                            weight_decay=0.01)
        start()
        loss = m(*(torch.from_numpy(a).to(device) for a in data))
        loss.backward()
        grads = {n: p.grad.detach().float().cpu()
                 for n, p in m.named_parameters() if p.grad is not None}
        o.step()
        after = {n: p.detach().float().cpu() for n, p in m.named_parameters()}
        runs.append((loss.item(), grads, after, init, launches()))
        del m, o, loss
    (cl, cg, ca, c0, _), (gl, gg, ga, g0, card_counts) = runs
    check(all(torch.equal(c0[n], g0[n]) for n in c0),
          "21c: the two models' initial weights differ")
    check(card_counts == (2, 2, 2), f"21c: card launches {card_counts}")
    rel = abs(gl - cl) / abs(cl)
    check(rel <= LOSS_RTOL, f"21c: loss card {gl} vs CPU {cl}")
    worst, where = rel_grads(torch, gg, cg, GRAD_TOL, "21c")
    mv, mv_where, scale = moves_apart(torch, ga, ca, c0, small.hidden_size)
    check(mv <= OPT_SIGN_TOL, f"21c: the move of {mv_where} is {mv:.3e} of "
          f"the CPU's apart (tol {OPT_SIGN_TOL})")
    print(f"    loss card {gl:.6f} vs CPU {cl:.6f}: rel diff {rel:.3e} (tol "
          f"{LOSS_RTOL}); {len(cg)} grads: worst max|diff|/max|grad| "
          f"{worst:.3e} at {where} (tol {GRAD_TOL}); one AdamW step's "
          f"moves up to {scale:.3e}, at most {mv:.3e} of a tensor's CPU "
          f"move apart ({mv_where}; tol {OPT_SIGN_TOL}); K1/K2/K3 "
          f"launches {card_counts}")
    del runs, cg, gg, ca, ga, c0, g0

    try:
        paddle.set_device("gpu")
        enc_counts = phase_encoder(torch, attn, paddle, start, launches)
        phase_sparse(torch, paddle)
    finally:
        device_mod._current_place = None
    phase_linalg(torch, paddle)
    return bert_counts, card_counts, enc_counts


def phase_encoder(torch, attn, paddle, start, launches):
    """21d: the Paddle surface's TransformerEncoder at BERT-base width
    (d_model 768, 12 heads, dim_feedforward 3072, 12 layers, post-norm,
    dropout 0, f32) on [8, 512, 768]. The output and every grad of the
    flash route, of K1 with K2/K3's plain version taking P and the
    rowsum each way (FLASH_ROUTE_GRAD_TOL says why), and
    of the reference's composition (MHA's other route, forced per layer),
    each against an f64 run of the composition; 2 AdamW steps at K1 = K2 = K3 = 12 each; a
    src_mask call through the composition (no K1); then save / load of
    the layer's and the optimizer's state dicts into fresh objects, whose
    next step gives the uninterrupted step's bits."""
    import tempfile
    from paddle_tpu_torch.core import lazy
    nn = paddle.nn
    b, s, d = ENCODER_SHAPE[0], ENCODER_SHAPE[2], 768
    L = 12

    def make(seed):
        paddle.seed(seed)
        layer = nn.TransformerEncoderLayer(d, 12, 3072, dropout=0.0)
        return nn.TransformerEncoder(layer, L)

    print(f"  [21d] the Paddle surface's TransformerEncoder: {L} layers at "
          f"BERT-base width on [{b}, {s}, {d}], f32")
    enc = make(210)
    rs = np.random.RandomState(21)
    x = paddle.to_tensor(rs.randn(b, s, d).astype("float32"))
    w = paddle.to_tensor(rs.randn(b, s, d).astype("float32") / d)
    params = list(enc.named_parameters())

    def plain_backward(q, k, v, o, lse, do, scale, causal, softmax, own):
        # K2/K3's plain version (the encoder is non-causal): P as the
        # flash formulation makes it, exp(S - LSE) with K1's LSE, or
        # (``softmax``) as the composition's softmax does; the rowsum as
        # the flash route takes it, rowsum(dO O), or (``own``) rowsum(P
        # dP) over the very P and dP that dS is made of
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
        s = scale * qf @ kf.transpose(-1, -2)
        p = s.softmax(-1) if softmax else torch.exp(s - lse.transpose(-1,
                                                                      -2))
        dp = dof @ vf.transpose(-1, -2)
        delta = ((p * dp).sum(-1, keepdim=True) if own else
                 (dof * o.float()).sum(-1, keepdim=True))
        ds = p * (dp - delta)
        return ((ds @ kf * scale).to(q.dtype),
                (ds.transpose(-1, -2) @ qf * scale).to(k.dtype),
                (p.transpose(-1, -2) @ dof).to(v.dtype))

    backwards = {f"plain, P {pn}, rowsum({rn})": functools.partial(
        plain_backward, softmax=pn == "softmax", own=rn == "P dP")
        for pn, rn in (("exp(S - LSE)", "dO O"), ("exp(S - LSE)", "P dP"),
                       ("softmax", "P dP"))}

    def run(route, xx, ww):
        if route == "composition":
            for lyr in enc.layers:
                lyr.self_attn.flash_route = lambda *a, **k: False
        kernels = attn.flash_attention_backward
        attn.flash_attention_backward = backwards.get(route, kernels)
        try:
            start()
            out = enc(xx)
            paddle.sum(out * ww).backward()
            lazy.flush()    # the backward runs with the route's kernels
        finally:
            attn.flash_attention_backward = kernels
        got = (out.value.detach().cpu(),
               {n: p.grad.value.cpu() for n, p in params}, launches())
        for _, p in params:
            p.clear_grad()
        for lyr in enc.layers:
            lyr.self_attn.__dict__.pop("flash_route", None)
        return got

    tols = {"flash": FLASH_ROUTE_GRAD_TOL,
            "composition": COMPOSITION_GRAD_TOL}
    tols.update((r, COMPOSITION_GRAD_TOL if "softmax" in r
                 else FLASH_ROUTE_GRAD_TOL) for r in backwards)
    want = {"flash": (L, L, L), "composition": (0, 0, 0)}
    routes = {r: run(r, x, w) for r in tols}
    enc.to(dtype="float64")
    t_out, t_grads, _ = run("composition", x.astype("float64"),
                            w.astype("float64"))
    enc.to(dtype="float32")
    f_counts = routes["flash"][2]
    check(all(c == want.get(r, (L, 0, 0)) for r, (_, _, c) in routes.items()),
          f"21d: launches {[(r, c) for r, (_, _, c) in routes.items()]}")
    noise = [n for n in t_grads if n.endswith("self_attn.k_proj.bias")]
    errs = {}
    for route, (out, grads, _) in routes.items():
        e_out = ((out.double() - t_out).abs().max()
                 / t_out.abs().max()).item()
        check(e_out <= LOSS_RTOL, f"21d: the {route} route's output "
              f"{e_out:.3e} of its largest from the f64 run's")
        errs[route] = (e_out, *rel_grads(torch, grads, t_grads, None,
                                         "21d", noise))
    check(all(errs[r][1] <= tols[r] for r in routes),
          "21d: grads off the f64 run's: " + "; ".join(
              f"{r} {errs[r][1:]} (tol {tols[r]})" for r in routes))
    apart, where = rel_grads(torch, routes["flash"][1],
                             routes["composition"][1], None, "21d", noise)
    print("    against an f64 run of the composition, output and worst "
          "grad, each of its largest: " + "; ".join(
              f"{r} {errs[r][0]:.3e}, {errs[r][1]:.3e} ({errs[r][2]}; tol "
              f"{tols[r]})" for r in routes)
          + f"; K1/K2/K3 {f_counts} on the flash route; it and the "
          f"composition {apart:.3e} apart ({where})")
    del routes, t_out, t_grads

    opt = paddle.optimizer.AdamW(1e-4, parameters=enc.named_parameters(),
                                 weight_decay=0.01)

    def step(model, o):
        start()
        loss = paddle.sum(model(x) * w)
        loss.backward()
        o.step()
        o.clear_grad()
        torch.cuda.synchronize()
        return loss.item(), launches()

    times, counts, losses = [], [], []
    for _ in range(2):
        t0 = time.perf_counter()
        loss, c = step(enc, opt)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        counts.append(c)
    check(all(c == (L, L, L) for c in counts),
          f"21d: launches a step {counts}")
    start()
    mask = nn.Transformer.generate_square_subsequent_mask(s)
    with paddle.no_grad():
        masked = enc(x, mask)
    check(launches() == (0, 0, 0)
          and bool(torch.isfinite(masked.value).all()),
          f"21d: a src_mask call launched {launches()}")
    del masked
    with tempfile.TemporaryDirectory() as tmp:
        paddle.save(enc.state_dict(), os.path.join(tmp, "enc.pdparams"))
        paddle.save(opt.state_dict(), os.path.join(tmp, "enc.pdopt"))
        loss3, c3 = step(enc, opt)
        want = {n: p.value.detach().clone() for n, p in enc.named_parameters()}
        del opt
        enc2 = make(211)
        opt2 = paddle.optimizer.AdamW(1e-4,
                                      parameters=enc2.named_parameters(),
                                      weight_decay=0.01)
        check(enc2.set_state_dict(paddle.load(
            os.path.join(tmp, "enc.pdparams"))) == [], "21d: names missing")
        opt2.set_state_dict(paddle.load(os.path.join(tmp, "enc.pdopt")))
        nbytes = sum(os.path.getsize(os.path.join(tmp, f))
                     for f in os.listdir(tmp))
    loss3b, c3b = step(enc2, opt2)
    same = [n for n, p in enc2.named_parameters()
            if not torch.equal(p.value, want[n])]
    check(loss3b == loss3 and not same and c3 == c3b == (L, L, L),
          f"21d: resumed step loss {loss3b} vs {loss3}, parameters apart "
          f"{same[:3]}, launches {c3b} / {c3}")
    print(f"    2 AdamW steps: losses {[round(v, 6) for v in losses]}, "
          f"step ms {[round(t, 2) for t in times]}, K1/K2/K3 {counts[0]} a "
          f"step; a src_mask call launched K1 0 times; save/load of the "
          f"layer and the optimizer ({nbytes / 2**20:.1f} MiB) into fresh "
          f"objects: the next step's loss {loss3b:.6f} and all "
          f"{len(want)} parameters the uninterrupted step's bits")
    del enc, enc2, opt2, want
    torch.cuda.empty_cache()
    return tuple(sum(c[i] for c in counts + [c3, c3b, f_counts])
                 for i in range(3))


def phase_sparse(torch, paddle):
    """21e: nn.Embedding(1_000_000, 768, sparse=True) (f32, 3.07 GB)
    under Adam(lazy_mode=True), then Adam(lazy_mode=False): 4096 lookups
    over 768 distinct rows. A first step makes the moments; on the
    second (other ids over other rows, a quarter shared): the grad is
    sparse, its coalesced rows under 1/1000 of the dense grad's bytes
    (the rows as looked up, one a lookup, are printed beside them), the
    step's peak above what it started with under one dense grad, and the
    table against a dense-grad Adam's over the same two steps: the
    difference's L2 norm within 1e-3 of the dense table's move (phase
    12's rule), and every element whose dense grads are 0 or at least
    SPARSE_GRAD_FLOOR within SPARSE_EL_TOL (the others, counted, are
    ill-conditioned: a grad near Adam's epsilon moves its element by up
    to lr either way on a rounding of the grad): lazy_mode over the rows
    the second step touches, the untouched ones unchanged by it; the
    default over every row."""
    nn = paddle.nn
    vocab, dim, n_ids, distinct = (SPARSE[k] for k in ("vocab", "dim",
                                                        "ids", "distinct"))
    dense_bytes = vocab * dim * 4
    lr, steps = 1e-2, 2
    rs = np.random.RandomState(22)
    pools = [rs.choice(vocab, distinct, replace=False) for _ in range(2)]
    pools[1][:distinct // 4] = pools[0][:distinct // 4]   # shared rows
    id_sets = [paddle.to_tensor(rs.choice(pool, n_ids).astype("int64"))
               for pool in pools]
    union = torch.from_numpy(np.unique(np.concatenate(pools))).cuda()
    w_np = (rs.randn(n_ids, dim) / dim).astype("float32")
    wt = paddle.to_tensor(w_np)
    print(f"  [21e] sparse grads: Embedding({vocab}, {dim}, sparse=True), "
          f"{n_ids} lookups over {distinct} rows a step, Adam")
    for lazy in (True, False):
        paddle.seed(23)
        emb = nn.Embedding(vocab, dim, sparse=True)
        ref = nn.Embedding(vocab, dim)
        ref.weight.set_value(emb.weight.value)
        init = emb.weight.value.clone()
        opt = paddle.optimizer.Adam(lr, parameters=emb.parameters(),
                                    lazy_mode=lazy)
        ropt = paddle.optimizer.Adam(lr, parameters=ref.parameters())
        ill = torch.zeros(len(union), dim, dtype=torch.bool,
                          device=union.device)
        for i, ids in enumerate(id_sets):
            paddle.sum(ref(ids) * wt).backward()
            rg = ref.weight.grad.value[union].abs()
            ill |= (rg > 0) & (rg < SPARSE_GRAD_FLOOR)
            ropt.step()
            ropt.clear_grad()
            before = emb.weight.value.clone() if i else None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            paddle.sum(emb(ids) * wt).backward()
            grad = emb.weight.grad
            check(grad.is_sparse(), "21e: the grad is not sparse")
            rows = grad.slices.coalesce()
            opt.step()
            opt.clear_grad()
            torch.cuda.synchronize()
            over = torch.cuda.max_memory_allocated() - held
        check(rows.nbytes < dense_bytes / 1000 and over < dense_bytes,
              f"21e: coalesced grad {rows.nbytes} B, the step's peak "
              f"{over} B over its start, dense grad {dense_bytes} B")
        touched = rows.indices
        got, want = emb.weight.value, ref.weight.value
        sel = touched if lazy else slice(None)
        diff = (got[sel] - want[sel]).abs()
        l2 = (diff.norm() / (want[sel] - init[sel]).norm()).item()
        # the ill-conditioned elements lie in rows of ``union``
        if lazy:
            skip = ill[torch.searchsorted(union, touched)]
            diff.masked_fill_(skip, 0.0)
        else:
            skip = ill
            diff[union] = diff[union].masked_fill(skip, 0.0)
        el = diff.max().item()
        check(el <= SPARSE_EL_TOL and l2 <= 1e-3,
              f"21e lazy={lazy}: an element {el} from the dense Adam's "
              f"(tol {SPARSE_EL_TOL}; {int(skip.sum())} ill-conditioned "
              f"left out), L2 {l2:.3e} of its move")
        del diff
        if lazy:
            keep = torch.ones(vocab, dtype=torch.bool, device=got.device)
            keep[touched] = False
            check(torch.equal(got[keep], before[keep]),
                  "21e: lazy_mode moved a row the step did not touch")
            tail = ("over the rows it touched; the other rows unchanged "
                    "by the step")
            del keep
        else:
            tail = "over every row"
        print(f"    lazy_mode={lazy}: grad {grad.slices.nbytes / 2**20:.2f} "
              f"MiB as looked up ({int(grad.slices.indices.numel())} rows), "
              f"{rows.nbytes / 2**20:.2f} MiB coalesced "
              f"({int(touched.numel())} rows; dense "
              f"{dense_bytes / 2**30:.3f} GiB, "
              f"{dense_bytes / rows.nbytes:.0f}x); step 2's peak "
              f"{over / 2**20:.1f} MiB over its start; against a "
              f"dense-grad Adam's 2 steps, {tail}: L2 {l2:.3e} of the "
              f"move (tol 1e-3), largest element {el:.2e} (tol "
              f"{SPARSE_EL_TOL}) with {int(skip.sum())} ill-conditioned "
              f"ones (a grad under {SPARSE_GRAD_FLOOR}) left out")
        del emb, ref, opt, ropt, grad, rows, got, want, before, init, ill
        torch.cuda.empty_cache()


def phase_linalg(torch, paddle):
    """21f: paddle.linalg on the card, seeded f32 and f64 batches, held
    to the CPU tests' invariants: solve (A X = B), cholesky (L L^T = A),
    svd (U S Vh = A, S the CPU's), qr (Q R = A, Q^T Q = I), eigh
    (V diag(w) V^T = A, w the CPU's), lu (P A = L U with its 1-based
    pivots), det (the CPU's), lstsq (the CPU's solution)."""
    print("  [21f] paddle.linalg on the card, f32 and f64")
    for dt, tol in (("float32", 1e-4), ("float64", 1e-10)):
        rs = np.random.RandomState(24)
        a = rs.randn(16, 64, 64) + 8 * np.eye(64)
        m = rs.randn(16, 64, 64)
        spd = m @ np.swapaxes(m, -1, -2) + 64 * np.eye(64)
        rhs = rs.randn(16, 64, 8)
        tall = rs.randn(16, 96, 48)
        b96 = rs.randn(96, 8)
        arrs = {k: v.astype(dt) for k, v in
                (("a", a), ("spd", spd), ("rhs", rhs), ("tall", tall),
                 ("b96", b96))}
        card = {k: paddle.to_tensor(v, place=paddle.CUDAPlace(0))
                for k, v in arrs.items()}
        cpu = {k: paddle.to_tensor(v, place=paddle.CPUPlace())
               for k, v in arrs.items()}
        T = {k: v.value for k, v in card.items()}
        worst = {}

        def rel(name, got, want):
            e = ((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30)).item()
            check(e <= tol, f"21f {dt} {name}: {e:.3e} (tol {tol})")
            worst[name] = e

        x = paddle.linalg.solve(card["a"], card["rhs"]).value
        check(x.is_cuda and x.dtype == getattr(torch, dt),
              f"21f: solve gave {x.dtype} on {x.device}")
        rel("solve", T["a"] @ x, T["rhs"])
        lo = paddle.linalg.cholesky(card["spd"]).value
        rel("cholesky", lo @ lo.transpose(-1, -2), T["spd"])
        u, s_, vh = (t.value for t in paddle.linalg.svd(card["tall"]))
        rel("svd", (u * s_[..., None, :]) @ vh, T["tall"])
        rel("svd S", s_.cpu(), paddle.linalg.svd(cpu["tall"])[1].value)
        q_, r_ = (t.value for t in paddle.linalg.qr(card["tall"]))
        rel("qr", q_ @ r_, T["tall"])
        eye = torch.eye(q_.shape[-1], dtype=q_.dtype, device=q_.device)
        rel("qr Q^T Q", q_.transpose(-1, -2) @ q_, eye.expand_as(
            q_.transpose(-1, -2) @ q_))
        wv, vv = (t.value for t in paddle.linalg.eigh(card["spd"]))
        rel("eigh", (vv * wv[..., None, :]) @ vv.transpose(-1, -2),
            T["spd"])
        rel("eigh w", wv.cpu(), paddle.linalg.eigh(cpu["spd"])[0].value)
        lu_, piv = (t.value for t in paddle.linalg.lu(card["a"]))
        pm, lm, um = torch.lu_unpack(lu_, piv)
        check(piv.dtype == torch.int32 and int(piv.min()) >= 1,
              "21f: lu pivots")
        rel("lu", pm @ lm @ um, T["a"])
        # det of 16 x 16 blocks: a 64 x 64 one overflows f32
        rel("det", paddle.linalg.det(card["a"][:, :16, :16]).value.cpu(),
            paddle.linalg.det(cpu["a"][:, :16, :16]).value)
        rel("lstsq", paddle.linalg.lstsq(card["tall"][0],
                                         card["b96"])[0].value.cpu(),
            paddle.linalg.lstsq(cpu["tall"][0], cpu["b96"])[0].value)
        print(f"    {dt}: " + ", ".join(f"{n} {e:.2e}"
                                        for n, e in worst.items())
              + f" (largest error over the largest value; tol {tol})")


# ---------------------------------------------------------------- phase 22

# phase 22: the reference's config 2 (bench.py:186-211: ResNet-50, AMP O2
# bf16, Momentum with weight decay, batch 128 of [3, 224, 224]) and
# config 1 (tools/baseline_bench.py:27-45: LeNet, Adam 1e-3, batch 64)
RESNET = dict(batch=128, size=224, classes=1000, steps=8)
LENET = dict(batch=64, steps=20)
# 22a, 22c: an op or a model on the card against the same on the CPU in
# f32 (TF32 off in cuBLAS and cuDNN): values and grads within this share
# of the largest element (a conv's sums over up to 25k products in
# another order, cuDNN's against oneDNN's); the max pool's picks, masks
# and tie grads (binary fractions of a cotangent of ones) exactly
VISION_TOL = 1e-4
# 22b, the eval forward under O2 against the f32 forward: the argmax must
# agree on every row whose f32 top-2 margin is at least this share of
# the row's logit range (bf16 activations through 53 convs and batch
# norms move a logit by a few per cent of the range)
VISION_MARGIN = 0.05


def vision_on(paddle, device, fn):
    """``fn()`` with the port's current device set to ``device``, then
    back to the card."""
    paddle.set_device(device)
    try:
        return fn()
    finally:
        paddle.set_device("gpu")


def vision_case(torch, paddle, label, fn, arrays, exact=False):
    """22a: ``fn`` over Tensors of ``arrays`` on the card and on the CPU,
    f32; every output and every float input's grad against a cotangent
    (ones where ``exact``: the max pool's grads are then sums of binary
    fractions, the same bits on both sides), the card's within
    VISION_TOL of the CPU's largest element, or equal where ``exact``.
    Returns the worst error."""
    runs = []
    for dev in ("cuda", "cpu"):
        ts = [paddle.Tensor._wrap(torch.tensor(
            a, device=dev, requires_grad=a.dtype.kind == "f"))
            for a in arrays]
        out = fn(*ts)
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        total = None
        for k, o in enumerate(outs):
            if o.value.is_floating_point():
                cot = torch.ones_like(o.value) if exact else torch.from_numpy(
                    np.random.RandomState(k).randn(*o.shape).astype(
                        np.float32)).to(dev)
                term = (o.value * cot).sum()
                total = term if total is None else total + term
        total.backward()
        runs.append([o.value.detach().cpu() for o in outs]
                    + [t.value.grad.cpu() for t in ts
                       if t.value.grad is not None])
    worst = 0.0
    for got, want in zip(*runs):
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"22a: {label}: {got.shape} {got.dtype} vs {want.shape} "
              f"{want.dtype}")
        if exact or not got.is_floating_point():
            check(torch.equal(got, want), f"22a: {label}: not the CPU's "
                  f"bits")
            continue
        err = ((got.double() - want.double()).abs().max()
               / want.abs().max().clamp_min(1e-30)).item()
        check(err <= VISION_TOL, f"22a: {label}: {err:.3e} of the largest "
              f"(tol {VISION_TOL})")
        worst = max(worst, err)
    print(f"    {label}: " + ("the CPU's bits" if exact else
                              f"worst {worst:.3e} of the largest (tol "
                              f"{VISION_TOL})"))
    return worst


def vision_ops(torch, paddle):
    """22a: ResNet-50's ops at its own shapes with batch 2, and
    MobileNet's depthwise conv, card against CPU."""
    F = paddle.nn.functional
    rs = np.random.RandomState(22)

    def r(*shape, scale=1.0):
        return (rs.randn(*shape) * scale).astype(np.float32)

    for label, x, w, kw in (
            ("stem conv 7x7/2 [2,3,224,224]", (2, 3, 224, 224),
             (64, 3, 7, 7), dict(stride=2, padding=3)),
            ("bottleneck 1x1 [2,256,56,56] -> 64", (2, 256, 56, 56),
             (64, 256, 1, 1), {}),
            ("bottleneck 3x3/2 [2,128,56,56]", (2, 128, 56, 56),
             (128, 128, 3, 3), dict(stride=2, padding=1)),
            ("downsample 1x1/2 [2,256,56,56] -> 512", (2, 256, 56, 56),
             (512, 256, 1, 1), dict(stride=2)),
            ("MobileNetV2 depthwise 3x3/2 [2,144,56,56]", (2, 144, 56, 56),
             (144, 1, 3, 3), dict(stride=2, padding=1, groups=144))):
        vision_case(torch, paddle, label,
                    lambda a, b, kw=kw: F.conv2d(a, b, **kw),
                    [r(*x), r(*w, scale=0.1)])
    ties = rs.randint(0, 4, (2, 64, 112, 112)).astype(np.float32)
    vision_case(torch, paddle, "MaxPool2D(3, 2, 1) and its grad, planted "
                "ties [2,64,112,112]", paddle.nn.MaxPool2D(3, 2, 1), [ties],
                exact=True)
    vision_case(torch, paddle, "max_pool2d's mask, the same ties",
                lambda a: F.max_pool2d(a, 3, 2, 1, return_mask=True),
                [ties], exact=True)

    x = r(2, 256, 56, 56, scale=2.0) + 0.5
    cot = r(2, 256, 56, 56)
    bns = [vision_on(paddle, d, lambda: paddle.nn.BatchNorm2D(256))
           for d in ("gpu", "cpu")]
    states = []
    for bn, dev in zip(bns, ("cuda", "cpu")):
        bn.train()
        xt = paddle.Tensor._wrap(torch.tensor(x, device=dev,
                                              requires_grad=True))
        out = bn(xt)
        (out.value * torch.from_numpy(cot).to(dev)).sum().backward()
        bn.eval()
        ev = bn(paddle.Tensor._wrap(torch.tensor(x, device=dev)))
        states.append([t.detach().cpu() for t in (
            out.value, xt.value.grad, bn._mean.value, bn._variance.value,
            ev.value)])
    worst = max(((g - w).abs().max() / w.abs().max()).item()
                for g, w in zip(*states))
    check(worst <= VISION_TOL, f"22a: BatchNorm2D: {worst:.3e}")
    print(f"    BatchNorm2D(256) train (output, grad), running _mean / "
          f"_variance after the step, eval output, [2,256,56,56]: worst "
          f"{worst:.3e} of the largest (tol {VISION_TOL})")
    vision_case(torch, paddle, "AdaptiveAvgPool2D((1, 1)) [2,2048,7,7]",
                paddle.nn.AdaptiveAvgPool2D((1, 1)), [r(2, 2048, 7, 7)])
    img = r(2, 64, 56, 56)
    for mode in ("nearest", "bilinear", "bicubic"):
        for align in (False, True):
            for size in ((112, 80), (28, 30)):
                vision_case(
                    torch, paddle, f"interpolate {mode} align_corners="
                    f"{align} [2,64,56,56] -> {size}",
                    lambda a, m=mode, al=align, s=size: F.interpolate(
                        a, size=s, mode=m, align_corners=al), [img])
    grid = rs.uniform(-1.1, 1.1, (2, 56, 56, 2)).astype(np.float32)
    for pad in ("zeros", "border", "reflection"):
        vision_case(torch, paddle, f"grid_sample bilinear {pad} "
                    "[2,64,56,56]", lambda a, g, p=pad: F.grid_sample(
                        a, g, padding_mode=p), [img, grid])


def vision_class(part, name):
    """A kernel's class in 22b's profile: the optimizer's part by its
    range, the rest by the kernel's name."""
    n = name.lower()
    if part == "vision/optimizer":
        return "optimizer (Momentum)"
    if any(t in n for t in ("conv", "xmma", "cudnn", "implicit", "gemm",
                            "cutlass", "sm90", "nchw", "nhwc", "wgrad",
                            "dgrad", "nvjet", "winograd", "fft")):
        return "convolutions and the fc (cuDNN, cuBLAS)"
    if "maximum" in n or "pad" in n or "max_pool" in n:
        return "pooling (the maximum chain, padding)"
    if "reduce" in n or "welford" in n:
        return "reductions (batch-norm statistics, the mean pool, loss)"
    if "copy" in n or "fill" in n:
        return "casts, copies and fills"
    return "elementwise (batch-norm affine, ReLU, residual adds)"


def vision_work(paddle, net, size):
    """The work of one image through ``net``, counted by forward hooks
    over one eval forward of a zero image: conv FLOPs (2 a
    multiply-add) and the elements its batch norms and ReLUs see."""
    counts = {"conv": 0, "bn": 0, "relu": 0}
    hooks = []

    def hook(kind):
        def h(layer, inputs, out):
            n = int(np.prod(out.shape[1:]))
            counts[kind] += 2 * n * int(np.prod(layer.weight.shape[1:])) \
                if kind == "conv" else n
        return h
    kinds = {"Conv2D": "conv", "BatchNorm2D": "bn", "ReLU": "relu"}
    for layer in net.sublayers():
        kind = kinds.get(type(layer).__name__)
        if kind:
            hooks.append(layer.register_forward_post_hook(hook(kind)))
    net.eval()
    with paddle.no_grad():
        net(paddle.zeros([1, 3, size, size]))
    net.train()
    for h in hooks:
        h.remove()
    print(f"    one {size}x{size} image forward: {counts['conv'] / 1e9:.3f} "
          f"GFLOP of convs, {counts['bn'] / 1e6:.3f} M batch-normed and "
          f"{counts['relu'] / 1e6:.3f} M ReLU'd elements")
    return counts


def vision_resnet50(torch, paddle, amp):
    """22b: the reference's config 2 eager, on the immediate path
    (FLAGS_lazy_eager False: its profile times the forward, backward and
    update apart): resnet50(num_classes=1000)
    from paddle_tpu_torch.seed(0), Momentum(0.1, momentum=0.9,
    weight_decay=1e-4), CrossEntropyLoss, the forward and the loss under
    amp.auto_cast(level="O2", dtype="bfloat16"), the same seeded batch of
    128 x [3, 224, 224] every step. Then the profile and the eval
    forward."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.vision import models
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from profile_port_serving import union_us
    paddle.set_flags({"FLAGS_lazy_eager": False})
    try:
        return _vision_resnet50(torch, paddle, amp, profile,
                                ProfilerActivity, models, union_us)
    finally:
        paddle.set_flags({"FLAGS_lazy_eager": True})


def _vision_resnet50(torch, paddle, amp, profile, ProfilerActivity, models,
                     union_us):
    paddle.seed(0)
    net = models.resnet50(num_classes=RESNET["classes"])
    n_params = sum(p.value.numel() for p in net.parameters())
    opt = paddle.optimizer.Momentum(0.1, momentum=0.9,
                                    parameters=net.parameters(),
                                    weight_decay=1e-4)
    loss_fn = paddle.nn.CrossEntropyLoss()
    rs = np.random.RandomState(0)
    b, s = RESNET["batch"], RESNET["size"]
    work = vision_work(paddle, net, s)
    x = paddle.to_tensor(rs.randn(b, 3, s, s).astype("float32"))
    y = paddle.to_tensor(rs.randint(0, RESNET["classes"], (b,)).astype(
        "int64"))

    def part(label, fn, sync):
        with torch.profiler.record_function(label):
            out = fn()
            if sync:
                torch.cuda.synchronize()
        return out

    def step(sync=False):
        def forward():
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                return loss_fn(net(x), y)
        loss = part("vision/forward", forward, sync)
        part("vision/backward", loss.backward, sync)

        def update():
            opt.step()
            opt.clear_grad()
        part("vision/optimizer", update, sync)
        return loss

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(RESNET["steps"]):
        t0 = time.perf_counter()
        loss = step()
        losses.append(float(loss.value.float().item()))
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"22b: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"22b: loss did not fall: {losses}")
    step_ms = float(np.median(times[1:]))
    conv_ms = bound(0, 3 * work["conv"] * b, "bfloat16")[0]
    print(f"    the convs' forward and backward, {3 * work['conv'] * b / 1e12:.2f}"
          f" TFLOP a step: {conv_ms:.2f} ms at the bf16 peak")
    print(f"    {n_params / 1e6:.2f} M parameters, batch {b} x [3, {s}, "
          f"{s}], loss dtype {loss.dtype.name}; losses "
          f"{[round(v, 4) for v in losses]}; step ms "
          f"{[round(t, 2) for t in times]}")
    print(f"    median step (steps 2-{RESNET['steps']}) {step_ms:.2f} ms, "
          f"{b / step_ms * 1e3:.1f} samples/s; the steps' own peak "
          f"{(peak - held) / 2**30:.3f} GiB over the {held / 2**30:.3f} "
          f"GiB held before them ({peak / 2**30:.3f} GiB in all)")

    n_prof = 2
    kinds = (torch.autograd.DeviceType.CUDA,)
    parts_of = ("vision/forward", "vision/backward", "vision/optimizer")
    for sync in (False, True):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_prof):
                step(sync)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        kernels = [e for e in events if e.device_type in kinds
                   and e.name not in parts_of]
        check(kernels, "22b: the profiler saw no device activity")
        spans = [(e.time_range.start, e.time_range.end) for e in kernels]
        if not sync:
            window = max(e for _, e in spans) - min(st for st, _ in spans)
            busy = union_us(spans)
            print(f"    profiled {n_prof} steps: wall {wall:.2f} ms, device "
                  f"window {window / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, "
                  f"idle share {1 - busy / window:.4f}")
            continue
        # each part closed by a sync: a kernel belongs to the range its
        # start falls in
        ranges = [(e.name, e.time_range.start, e.time_range.end)
                  for e in events if e.name in parts_of
                  and e.device_type == torch.autograd.DeviceType.CPU]
        by_class, by_part, outside = {}, {}, {}
        for e in kernels:
            label = next((nm for nm, a, z in ranges
                          if a <= e.time_range.start <= z), None)
            if label is None:
                # launched by another thread of the process (an earlier
                # phase's), not by the steps
                outside[e.name] = outside.get(e.name, 0) + 1
                continue
            c = vision_class(label, e.name)
            d = e.time_range.end - e.time_range.start
            n, t = by_class.get(c, (0, 0.0))
            by_class[c] = (n + 1, t + d)
            n, t = by_part.get(label, (0, 0.0))
            by_part[label] = (n + 1, t + d)
        total = sum(t for _, t in by_class.values())
        print(f"    a step's kernels by part (sync-closed): " + ", ".join(
            f"{p.split('/')[1]} {n / n_prof:.0f} ({t / n_prof / 1e3:.3f} ms)"
            for p, (n, t) in sorted(by_part.items()))
            + f"; {sum(outside.values())} device activities outside the "
            f"parts, not counted" + "".join(
                f"; {n} x {name[:60]}" for name, n in sorted(
                    outside.items(), key=lambda kv: -kv[1])[:3]))
        for c, (n, t) in sorted(by_class.items(), key=lambda kv: -kv[1][1]):
            print(f"      {c:56s} {n / n_prof:6.0f} launches "
                  f"{t / n_prof / 1e3:9.3f} ms a step ({t / total:.4f})")

    net.eval()
    with paddle.no_grad():
        ips = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                low = net(x).value.float()
            torch.cuda.synchronize()
            ips.append(b / (time.perf_counter() - t0))
        f32 = net(x).value
    top2 = f32.topk(2, dim=1).values
    margin = top2[:, 0] - top2[:, 1]
    rng = f32.max(dim=1).values - f32.min(dim=1).values
    rows = margin >= VISION_MARGIN * rng
    same = low.argmax(1) == f32.argmax(1)
    check(bool(same[rows].all()), f"22b: eval argmax differs on "
          f"{int((~same[rows]).sum())} of the {int(rows.sum())} rows with "
          f"a clear margin")
    print(f"    eval forward, O2 bf16, batch {b}: "
          f"{float(np.median(ips[1:])):.1f} images/s (median of 3 after "
          f"one); argmax the f32 forward's on all {int(rows.sum())} rows "
          f"whose f32 top-2 margin is at least {VISION_MARGIN} of the "
          f"logit range ({int(same.sum())} of {b} rows in all)")
    del net, opt, x, y, loss, low, f32
    torch.cuda.empty_cache()
    return step_ms


def vision_grads(paddle, model, x, y):
    """The CrossEntropyLoss of ``model(x)`` and every grad (on the CPU)."""
    loss = paddle.nn.CrossEntropyLoss()(model(x), y)
    loss.backward()
    return float(loss.value.item()), {
        n: p.grad.value.detach().cpu() for n, p in model.named_parameters()}


def vision_card_vs_cpu(torch, paddle):
    """22c: resnet18(num_classes=10) built on the CPU from a seed and moved
    to the card as its twin; 2 Momentum steps on two seeded [2, 3, 64,
    64] batches each side. Step 1's loss and grads card against CPU;
    step 2 starts from parameters that step 1's rounding set apart, and
    a model's grads amplify that, so its grads are held to a third model
    on the CPU loaded with the card's state after step 1 (the same point,
    only the arithmetic differs), and the CPU's own distance there is
    printed. Then LeNet and mobilenet_v2(num_classes=10) forward."""
    from paddle_tpu_torch.vision import models
    rs = np.random.RandomState(22)
    data = [(rs.randn(2, 3, 64, 64).astype("float32"),
             rs.randint(0, 10, (2,)).astype("int64")) for _ in range(2)]

    def twins(make):
        paddle.seed(7)
        cpu = vision_on(paddle, "cpu", make)
        card = vision_on(paddle, "cpu", make)
        card.set_state_dict({k: v.value for k, v in cpu.state_dict().items()})
        return card.to(device="gpu"), cpu

    def on(place, i):
        return (paddle.to_tensor(data[i][0], place=place),
                paddle.to_tensor(data[i][1], place=place))

    def momentum(model):
        return paddle.optimizer.Momentum(0.1, momentum=0.9,
                                         parameters=model.parameters(),
                                         weight_decay=1e-4)

    def stats(model):
        return {k: v.value.detach().cpu() for k, v in
                model.state_dict().items()
                if k.endswith(("_mean", "_variance"))}

    make = lambda: models.resnet18(num_classes=10)  # noqa: E731
    gpu, cpu_place = paddle.CUDAPlace(0), paddle.CPUPlace()
    card, cpu = twins(make)
    opts = [momentum(card), momentum(cpu)]
    losses, grads = [], []
    for i in range(2):
        if i == 1:
            at_card = vision_on(paddle, "cpu", make)
            at_card.set_state_dict({k: v.value.cpu()
                                    for k, v in card.state_dict().items()})
            there = vision_grads(paddle, at_card, *on(cpu_place, 1))
        step = [vision_grads(paddle, card, *on(gpu, i)),
                vision_grads(paddle, cpu, *on(cpu_place, i))]
        for o in opts:
            o.step()
            o.clear_grad()
        losses.append([v for v, _ in step])
        grads.append([g for _, g in step])
    for i, (a, b_) in enumerate(losses):
        check(abs(a - b_) <= LOSS_RTOL * abs(b_), f"22c: step {i + 1} loss "
              f"card {a} vs CPU {b_}")
    step1, _ = rel_grads(torch, grads[0][0], grads[0][1], GRAD_TOL,
                         "22c step 1, card vs CPU")
    step2, where = rel_grads(torch, grads[1][0], there[1], GRAD_TOL,
                             "22c step 2, card vs the CPU at the card's "
                             "point")
    apart, _ = rel_grads(torch, grads[1][0], grads[1][1], None, "")
    own, _ = rel_grads(torch, there[1], grads[1][1], None, "")
    st = max(((a - b_).abs().max() / b_.abs().max()).item() for a, b_ in
             zip(stats(card).values(), stats(at_card).values()))
    check(st <= VISION_TOL, f"22c: running statistics {st:.3e}")
    print(f"    resnet18(num_classes=10), [2, 3, 64, 64], 2 Momentum steps: "
          f"losses card {[round(a, 6) for a, _ in losses]} vs CPU "
          f"{[round(b_, 6) for _, b_ in losses]} (rtol {LOSS_RTOL}); step "
          f"1's grads within {step1:.3e} of their largest, step 2's within "
          f"{step2:.3e} of the CPU's at the card's point ({where}; tol "
          f"{GRAD_TOL}), {apart:.3e} of the CPU's own (the CPU at the two "
          f"points: {own:.3e}); _mean / _variance after step 2 within "
          f"{st:.3e} of the CPU's at the card's point (tol {VISION_TOL})")
    del card, cpu, at_card
    for label, make, shape, mode in (
            ("LeNet()", models.LeNet, (2, 1, 28, 28), "train"),
            ("mobilenet_v2(num_classes=10)",
             lambda: models.mobilenet_v2(num_classes=10), (2, 3, 64, 64),
             "eval")):
        card, cpu = twins(make)
        getattr(card, mode)()
        getattr(cpu, mode)()
        xs = rs.randn(*shape).astype("float32")
        got = card(paddle.to_tensor(xs)).value.cpu()
        want = cpu(paddle.to_tensor(xs, place=cpu_place)).value
        err = ((got - want).abs().max() / want.abs().max()).item()
        check(err <= VISION_TOL, f"22c: {label} forward {err:.3e}")
        print(f"    {label} forward ({mode}), {list(shape)}: within "
              f"{err:.3e} of the CPU's largest logit (tol {VISION_TOL})")


def vision_lenet(torch, paddle):
    """22d: the reference's config 1 eager: LeNet, Adam(1e-3),
    CrossEntropyLoss, batch 64 of [1, 28, 28] (seeded numpy), 20 steps."""
    from paddle_tpu_torch.vision import models
    paddle.seed(0)
    net = models.LeNet()
    opt = paddle.optimizer.Adam(1e-3, parameters=net.parameters())
    loss_fn = paddle.nn.CrossEntropyLoss()
    rs = np.random.RandomState(1)
    b = LENET["batch"]
    x = paddle.to_tensor(rs.randn(b, 1, 28, 28).astype("float32"))
    y = paddle.to_tensor(rs.randint(0, 10, (b,)).astype("int64"))
    losses, times = [], []
    for _ in range(LENET["steps"]):
        t0 = time.perf_counter()
        loss = loss_fn(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.value.item()))
        times.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"22d: losses {losses}")
    step_ms = float(np.median(times[1:]))
    print(f"    LeNet, Adam 1e-3, batch {b}, {LENET['steps']} steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; median step (steps 2-"
          f"{LENET['steps']}) {step_ms:.3f} ms, {b / step_ms * 1e3:.1f} "
          f"samples/s")
    return step_ms


def phase_vision(torch, amp):
    """Phase 22: the vision surface on the card. 22a ResNet-50's ops card
    against CPU; 22b the reference's config 2 (ResNet-50, O2 bf16,
    Momentum, batch 128) with its profile and eval forward; 22c whole
    models card against CPU; 22d config 1 (LeNet). Returns its wall
    seconds."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as device_mod
    t0 = time.perf_counter()
    paddle.set_device("gpu")
    try:
        print("  [22a] ResNet-50's ops at its shapes (batch 2), card "
              "against CPU, f32")
        vision_ops(torch, paddle)
        print("  [22b] ResNet-50 config 2: O2 bf16, Momentum, batch "
              f"{RESNET['batch']} x [3, {RESNET['size']}, {RESNET['size']}]")
        vision_resnet50(torch, paddle, amp)
        print("  [22c] card against CPU: resnet18 2 Momentum steps, LeNet "
              "and mobilenet_v2 forward, f32")
        vision_card_vs_cpu(torch, paddle)
        print("  [22d] LeNet config 1: Adam, batch 64, eager")
        vision_lenet(torch, paddle)
    finally:
        device_mod._current_place = None
    secs = time.perf_counter() - t0
    print(f"  phase 22 in {secs:.1f} s")
    return secs


# ---------------------------------------------------------------- phase 23

# phase 23: the recurrent surface and an LSTM encoder-decoder at the width
# of PaddleNLP's examples/machine_translation/seq2seq (IWSLT15 en-vi:
# vocabularies 17191 / 7709, 2 layers of 512, dropout 0.2, uniform init
# 0.1, Adam 1e-3 with ClipGradByGlobalNorm(5.0), batch 128, beam 10),
# without its attention, over the reference's synthetic WMT16
S2S = dict(src_vocab=17191, trg_vocab=7709, hidden=512, layers=2,
           dropout=0.2, init=0.1, batch=128, epochs=4, beam=10, steps=32,
           small_hidden=64, small_src=500, small_trg=400)
# 23a: shapes of the path's ops (the RNNs at the encoder's [128, 24, 512],
# DeepSpeech2's English CTC [T=200, B=16, C=29], hsigmoid over the target
# vocabulary, the decode's gather_tree, Conll05's 67 labels)
RNN_SHAPE = (128, 24, 512)
# 23a, 23d: card against CPU in f32 (TF32 off), relative to each output's
# or grad's largest element: sums of up to 1024 products a gate, carried
# through 24 steps, in another order (cuDNN's RNN against the CPU's)
RNN_TOL = 1e-4
# 23c: beam ids card against CPU, except rows where a step's k-th and
# (k+1)-th candidates lie within this (phase 5's rule)
BEAM_MARGIN = 1e-4


def flat_out(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in flat_out(x)]
    return [out]


def rnn_case(torch, paddle, label, call, arrays, make=None, tol=RNN_TOL,
             exact=False, dtype="float32"):
    """23a: ``call(layer, *tensors)`` (``layer`` None without ``make``) on
    the card and on the CPU in ``dtype``, the layer made on the CPU from a
    seed and carried to its card twin; every output, the float inputs'
    grads and every weight's grad against fixed cotangents, the card's
    within ``tol`` of the CPU's largest element (equal where ``exact`` or
    an integer). Returns the worst error."""
    arrays = [a.astype(dtype) if a.dtype.kind == "f" else a for a in arrays]
    layers = [None, None]
    if make is not None:
        paddle.seed(23)
        cpu = vision_on(paddle, "cpu", make).to(dtype=dtype)
        card = vision_on(paddle, "cpu", make).to(dtype=dtype)
        card.set_state_dict({k: v.value for k, v in cpu.state_dict().items()})
        layers = [card.to(device="gpu"), cpu]
    runs = []
    for layer, dev in zip(layers, ("cuda", "cpu")):
        ts = [paddle.Tensor._wrap(torch.tensor(
            a, device=dev, requires_grad=a.dtype.kind == "f" and not exact))
            for a in arrays]
        outs = flat_out(call(layer, *ts))
        total = None
        for k, o in enumerate(outs):
            if o.value.is_floating_point() and o.value.requires_grad:
                cot = torch.from_numpy(np.asarray(np.random.RandomState(
                    k).randn(*o.shape), np.float32)).to(o.value.device,
                                                        o.value.dtype)
                term = (o.value * cot).sum()
                total = term if total is None else total + term
        if total is not None:
            total.backward()
        params = layer.parameters() if layer is not None else []
        runs.append([o.value.detach().cpu() for o in outs]
                    + [t.value.grad.cpu() for t in ts
                       if t.value.grad is not None]
                    + [p.value.grad.cpu() for p in params])
    check(len(runs[0]) == len(runs[1]), f"23a: {label}: {len(runs[0])} vs "
          f"{len(runs[1])} results")
    worst = 0.0
    for i, (got, want) in enumerate(zip(*runs)):
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"23a: {label}: {got.shape} {got.dtype} vs {want.shape} "
              f"{want.dtype}")
        if exact or not got.is_floating_point():
            check(torch.equal(got, want), f"23a: {label}: not the CPU's "
                  f"values")
            continue
        err = ((got.double() - want.double()).abs().max()
               / want.double().abs().max().clamp_min(1e-30)).item()
        check(err <= tol, f"23a: {label}: result {i} of {len(runs[0])} "
              f"{list(got.shape)}: {err:.3e} of the largest (tol {tol})")
        worst = max(worst, err)
    print(f"    {label}: " + ("the CPU's values" if exact else
                              f"{len(runs[0])} tensors, worst {worst:.3e} "
                              f"of the largest (tol {tol})"))
    return worst


def rnn_kernels(torch, paddle, amp):
    """23a: the CUDA kernels one 2-layer LSTM forward and backward at the
    encoder's shape launches, in f32 and under O2 (bf16); cuDNN's warning
    about weights outside one flat buffer; the port's LSTM (its own
    parameters, which cuDNN copies into a flat buffer on every call)
    against torch's nn.LSTM over the same weights flattened once."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    b, t, h = RNN_SHAPE
    paddle.seed(23)
    lstm = paddle.nn.LSTM(h, h, num_layers=2)
    x = torch.randn(b, t, h, device="cuda")
    for dtype, level in (("float32", None), ("bfloat16", "O2")):
        def run():
            xt = paddle.Tensor._wrap(x.clone().requires_grad_(True))
            if level is None:
                y, _ = lstm(xt)
            else:
                with amp.auto_cast(level=level, dtype="bfloat16"):
                    y, _ = lstm(xt)
            y.value.float().sum().backward()
            lstm.clear_gradients()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                n, d = names.get(e.name, (0, 0.0))
                names[e.name] = (n + 1, d + e.time_range.end
                                 - e.time_range.start)
        print(f"    2-layer LSTM [{b}, {t}, {h}] forward + backward, {dtype}: "
              f"{sum(n for n, _ in names.values())} kernels; by time:")
        for name, (n, d) in sorted(names.items(),
                                   key=lambda kv: -kv[1][1])[:8]:
            print(f"      {n:5d} x {d / 1e3:8.3f} ms  {name[:110]}")
        msgs = sorted({str(w.message).split(".")[0] for w in caught})
        print(f"    warnings ({dtype}): " + ("; ".join(m[:120] for m in msgs)
                                           if msgs else "none"))
    ref_lstm = torch.nn.LSTM(h, h, num_layers=2, batch_first=True).cuda()
    with torch.no_grad():
        for name, p in ref_lstm.named_parameters():
            p.copy_(getattr(lstm, name).value)
    ref_lstm.flatten_parameters()
    xt = paddle.Tensor._wrap(x)
    with torch.no_grad():
        mine = time_ms(torch, lambda: lstm(xt), iters=10)
        flat = time_ms(torch, lambda: ref_lstm(x), iters=10)
        err = (lstm(xt)[0].value - ref_lstm(x)[0]).abs().max().item()
    print(f"    forward f32: the port's LSTM {mine:.3f} ms, torch's nn.LSTM "
          f"over one flat buffer of the same weights {flat:.3f} ms "
          f"(difference {mine - flat:.3f} ms: cuDNN's per-call copy of "
          f"{sum(p.value.numel() for p in lstm.parameters()) * 4 / 2**20:.1f}"
          f" MiB of weights, and the port's per-layer calls); max "
          f"difference {err:.2e}")


def rnn_ops(torch, paddle, amp):
    """23a: the path's ops card against CPU in f32."""
    F = paddle.nn.functional
    rs = np.random.RandomState(23)
    b, t, h = RNN_SHAPE
    x = rs.randn(b, t, h).astype(np.float32)
    h0 = rs.randn(4, b, h).astype(np.float32)
    # the relu RNN in f64: a preactivation within f32 rounding of 0 takes
    # relu's other branch on one side, and its grad flips whole (1.8e-2 of
    # the largest grad in f32 on an NVIDIA H100 80GB HBM3); f64 runs
    # cuDNN's same RNN with no such flip
    for name, make, dtype in (
            ("LSTM", lambda d: paddle.nn.LSTM(h, h, num_layers=2,
                                              direction=d), "float32"),
            ("GRU", lambda d: paddle.nn.GRU(h, h, num_layers=2,
                                            direction=d), "float32"),
            ("SimpleRNN tanh", lambda d: paddle.nn.SimpleRNN(
                h, h, num_layers=2, direction=d), "float32"),
            ("SimpleRNN relu", lambda d: paddle.nn.SimpleRNN(
                h, h, num_layers=2, direction=d, activation="relu"),
             "float64")):
        for d in ("forward", "bidirect"):
            arrays = [x]
            call = lambda m, a: m(a)  # noqa: E731
            if d == "bidirect" and name == "GRU":
                arrays, call = [x, h0], lambda m, a, s: m(a, s)
            rnn_case(torch, paddle, f"{name} {d} 2 layers [{b}, {t}, {h}]"
                     + (" from given states" if len(arrays) > 1 else "")
                     + ("" if dtype == "float32" else f", {dtype}"),
                     call, arrays, make=lambda d=d, make=make: make(d),
                     dtype=dtype)
    xc = x[:, 0]
    hc = rs.randn(b, h).astype(np.float32)
    rnn_case(torch, paddle, f"LSTMCell [{b}, {h}] from given (h, c)",
             lambda m, a, s, c: m(a, (s, c)), [xc, hc, hc * 0.5],
             make=lambda: paddle.nn.LSTMCell(h, h))
    rnn_case(torch, paddle, f"GRUCell [{b}, {h}] from a given state",
             lambda m, a, s: m(a, s), [xc, hc],
             make=lambda: paddle.nn.GRUCell(h, h))
    # DeepSpeech2's English CTC: 200 frames, 16 utterances, 28 characters
    # and the blank; unnormalised scores, row 0 infeasible (60 labels in
    # 20 frames), row 1 with repeats
    T, B, C, L = 200, 16, 29, 60
    scores = (rs.randn(T, B, C) * 4).astype(np.float32)
    labels = rs.randint(1, C, (B, L)).astype(np.int32)
    labels[1, :10] = [5, 5, 5, 7, 7, 2, 2, 2, 2, 9]
    il = rs.randint(150, T + 1, B).astype(np.int64)
    il[0] = 20
    ll = rs.randint(20, L + 1, B).astype(np.int64)
    ll[0] = L
    for red in ("none", "mean"):
        rnn_case(torch, paddle, f"ctc_loss {red} [T={T}, B={B}, C={C}], "
                 f"labels up to {L}, one infeasible row",
                 lambda _, s, lab, i, n, red=red: F.ctc_loss(
                     s, lab, i, n, reduction=red),
                 [scores, labels, il, ll])
    nc = S2S["trg_vocab"]
    rnn_case(torch, paddle, f"hsigmoid_loss num_classes={nc} [1280, {h}]",
             lambda _, a, lab, w, bias: F.hsigmoid_loss(a, lab, nc, w, bias),
             [rs.randn(1280, h).astype(np.float32),
              rs.randint(0, nc, (1280,)).astype(np.int64),
              (rs.randn(nc - 1, h) * 0.05).astype(np.float32),
              rs.randn(nc - 1).astype(np.float32)])
    rnn_case(torch, paddle, "gather_tree [32, 128, 10]",
             lambda _, i, p: F.gather_tree(i, p),
             [rs.randint(0, nc, (32, 128, 10)).astype(np.int64),
              rs.randint(0, 10, (32, 128, 10)).astype(np.int64)], exact=True)
    c = 67
    em = rs.randn(32, 32, c).astype(np.float32)
    trans = (rs.randn(c + 2, c) * 0.5).astype(np.float32)
    lab = rs.randint(0, c, (32, 32)).astype(np.int64)
    lens = rs.randint(1, 33, 32).astype(np.int64)
    rnn_case(torch, paddle, f"linear_chain_crf [32, 32, {c}]",
             lambda _, e, tr, y, n: paddle.ops.sequence.linear_chain_crf(
                 e, tr, y, n), [em, trans, lab, lens])
    paths = []
    for dev in ("cuda", "cpu"):
        args = [paddle.Tensor._wrap(torch.tensor(a, device=dev))
                for a in (em, trans, lens)]
        paths.append(paddle.ops.sequence.crf_decoding(*args).value.cpu())
    differ = (paths[0] != paths[1]).any(1)
    if bool(differ.any()):
        # a row may part only where its two paths score the same
        def score(p):
            args = [paddle.Tensor._wrap(torch.tensor(a)) for a in
                    (em, trans)] + [paddle.Tensor._wrap(p),
                                    paddle.Tensor._wrap(torch.tensor(lens))]
            return paddle.ops.sequence.linear_chain_crf(*args).value
        gap = (score(paths[0]) - score(paths[1])).abs().max().item()
        check(gap <= 1e-4, f"23a: crf_decoding parts from the CPU's by "
              f"{gap:.3e} in NLL")
    print(f"    crf_decoding [32, 32, {c}]: {int(differ.sum())} of 32 paths "
          f"differ from the CPU's (each only between paths of equal "
          f"score within 1e-4)")
    rnn_kernels(torch, paddle, amp)


def seq2seq_model(paddle, src_vocab, trg_vocab, hidden, layers, dropout,
                  init):
    """PaddleNLP's seq2seq without attention in the port's nn: source and
    target embeddings, an nn.LSTM encoder, a decoder cell of LSTMCells
    (dropout on each one's output) with flat states (h0, c0, h1, c1)
    started from the encoder's, run by nn.RNN, a Linear head; every
    parameter Uniform(-init, init)."""
    nn = paddle.nn

    class DecoderCell(nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.hidden_size = hidden
            self.cells = nn.LayerList([nn.LSTMCell(hidden, hidden)
                                       for _ in range(layers)])
            self.drop = nn.Dropout(dropout)

        def forward(self, x, states):
            new = []
            for i, cell in enumerate(self.cells):
                out, (h, c) = cell(x, (states[2 * i], states[2 * i + 1]))
                x = self.drop(out) if dropout else out
                new += [h, c]
            return x, tuple(new)

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_emb = nn.Embedding(src_vocab, hidden)
            self.trg_emb = nn.Embedding(trg_vocab, hidden)
            self.encoder = nn.LSTM(hidden, hidden, num_layers=layers,
                                   dropout=dropout)
            self.decoder = nn.RNN(DecoderCell())
            self.head = nn.Linear(hidden, trg_vocab)

        def encode(self, src, src_len=None):
            _, (h, c) = self.encoder(self.src_emb(src),
                                     sequence_length=src_len)
            return tuple(s for i in range(layers) for s in (h[i], c[i]))

        def forward(self, src, src_len, trg):
            out, _ = self.decoder(self.trg_emb(trg),
                                  self.encode(src, src_len))
            return self.head(out)

    u = nn.initializer.Uniform(-init, init)
    nn.initializer.set_global_initializer(u, u)
    try:
        return Seq2Seq()
    finally:
        nn.initializer.set_global_initializer(None)


def seq2seq_criterion(paddle):
    class CrossEntropyCriterion(paddle.nn.Layer):
        """PaddleNLP's: per-token CE times the target mask, mean over the
        batch, sum over time; the mask from the padded label (-100)."""

        def forward(self, logits, label):
            cost = paddle.nn.functional.cross_entropy(logits, label,
                                                      reduction="none")
            cost = paddle.reshape(cost, label.shape)
            mask = paddle.cast(paddle.greater_equal(
                label, paddle.zeros_like(label)), "float32")
            return paddle.sum(paddle.mean(cost * mask, axis=0))
    return CrossEntropyCriterion()


def pad_collate(batch):
    """(src, src_len, trg, label) padded to the batch's longest; the
    label (WMT16's trg_next) with -100."""
    b = len(batch)
    s_max = max(len(x[0]) for x in batch)
    t_max = max(len(x[1]) for x in batch)
    src = np.zeros((b, s_max), "int64")
    trg = np.zeros((b, t_max), "int64")
    label = np.full((b, t_max), -100, "int64")
    for i, (s, t, n) in enumerate(batch):
        src[i, :len(s)] = s
        trg[i, :len(t)] = t
        label[i, :len(n)] = n
    return src, np.array([len(x[0]) for x in batch], "int64"), trg, label


def seq2seq_opt(paddle, net):
    return paddle.optimizer.Adam(
        1e-3, parameters=net.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(5.0))


def rnn_class(chain, shapes, vocab):
    """A kernel's class in 23b's profile, from the names of the CPU op
    that launched it and its ancestors (and the op's input shapes)."""
    low = " ".join(chain).lower()
    if "rnn/optimizer" in low:
        return "optimizer (Adam, ClipGradByGlobalNorm)"
    if any(k in low for k in ("lstm", "gru", "cudnn_rnn", "cudnnrnn",
                              "rnn_tanh", "rnn_relu")):
        return "RNN ops (cuDNN's RNN, the fused LSTM cell)"
    if any(k in low for k in ("log_softmax", "logsoftmax", "nll_loss",
                              "nllloss", "cross_entropy")):
        return "cross-entropy (log-softmax, NLL)"
    dims = {d for s in (shapes or []) for d in (s or [])}
    if "mm" in low or "matmul" in low or "linear" in low:
        return ("the head's product and its grads" if vocab in dims
                else "the cells' gate products' grads")
    if "embedding" in low:
        return "embeddings"
    return "the rest (elementwise, casts, copies, the mask)"


def rnn_profile(torch, model, batch, vocab):
    """23b: two train_batch calls under torch.profiler: the idle share,
    launches a step, and device time a step by class (each kernel by the
    CPU op that launched it; the optimizer by a range around its step)."""
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from profile_port_serving import union_us
    opt = model._optimizer
    step = opt.step

    def ranged():
        with torch.profiler.record_function("rnn/optimizer"):
            return step()
    opt.step = ranged
    n_prof = 2
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            t0 = time.perf_counter()
            for _ in range(n_prof):
                model.train_batch(list(batch[:3]), [batch[3]])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        del opt.step
    events = prof.events()
    kinds = (torch.autograd.DeviceType.CUDA,)
    kernels = [e for e in events if e.device_type in kinds]
    check(kernels, "23b: the profiler saw no device activity")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    busy = union_us(spans)
    total = sum(e - s for s, e in spans)
    print(f"    profiled {n_prof} train_batch calls: wall {wall:.2f} ms, "
          f"device window {window / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, "
          f"idle share {1 - busy / window:.4f}; {len(kernels) / n_prof:.0f} "
          f"launches a step, {total / n_prof / 1e3:.3f} ms of kernels a step")
    # each CPU op's kernels (by name) give a class; a kernel name's time
    # in the trace is shared among the classes that launched it in
    # proportion to what they were credited with (the credited durations
    # need not sum to the trace's: on an H100 with torch 2.11 they fell
    # short by a third); a name no op was credited with goes by the name
    # alone
    credited = {}
    for e in events:
        if e.device_type in kinds or not getattr(e, "kernels", None):
            continue
        chain, p = [], e
        while p is not None:
            chain.append(p.name)
            p = p.cpu_parent
        c = rnn_class(chain, getattr(e, "input_shapes", None), vocab)
        for k in e.kernels:
            parts = credited.setdefault(k.name, {})
            n, d = parts.get(c, (0, 0.0))
            parts[c] = (n + 1, d + k.duration)
    traced = {}
    for e in kernels:
        n, d = traced.get(e.name, (0, 0.0))
        traced[e.name] = (n + 1, d + e.time_range.end - e.time_range.start)
    by_class, by_name = {}, 0.0
    for name, (n, d) in traced.items():
        parts = credited.get(name)
        if not parts:
            low = name.lower()
            parts = {("RNN ops (cuDNN's RNN, the fused LSTM cell)"
                      if any(k in low for k in ("rnn", "lstm", "gru"))
                      else "products no op was credited with"
                      if any(k in low for k in ("gemm", "nvjet", "xmma"))
                      else "the rest (elementwise, casts, copies, the "
                      "mask)"): (1, 1.0)}
            by_name += d
        cn = sum(c for c, _ in parts.values())
        cd = sum(t for _, t in parts.values())
        for c, (pn, pd) in parts.items():
            share = pd / cd if cd > 0 else pn / cn
            m, t = by_class.get(c, (0.0, 0.0))
            by_class[c] = (m + n * pn / cn, t + d * share)
    print(f"    a step's device time by class ({by_name / total:.4f} of it "
          f"classed by kernel name alone):")
    for c, (n, d) in sorted(by_class.items(), key=lambda kv: -kv[1][1]):
        print(f"      {c:50s} {n / n_prof:6.0f} launches "
              f"{d / n_prof / 1e3:9.3f} ms a step ({d / total:.4f})")


def rnn_train(torch, paddle):
    """23b: the encoder-decoder at full width trained through Model.fit
    over DataLoader(WMT16) at batch 128, 4 epochs (8 steps), f32; then
    the profile and evaluate. Returns the model."""
    from paddle_tpu_torch.text.datasets import WMT16
    paddle.seed(0)
    net = seq2seq_model(paddle, S2S["src_vocab"], S2S["trg_vocab"],
                        S2S["hidden"], S2S["layers"], S2S["dropout"],
                        S2S["init"])
    n_params = sum(p.value.numel() for p in net.parameters())
    n_emb = net.src_emb.weight.value.numel() + net.trg_emb.weight.value.numel()
    n_rnn = sum(p.value.numel() for n, p in net.named_parameters()
                if n.startswith(("encoder.", "decoder.")))
    model = paddle.Model(net)
    model.prepare(seq2seq_opt(paddle, net), seq2seq_criterion(paddle))
    data = WMT16(mode="train", src_dict_size=S2S["src_vocab"],
                 trg_dict_size=S2S["trg_vocab"])
    loader = paddle.io.DataLoader(data, batch_size=S2S["batch"],
                                  shuffle=False, collate_fn=pad_collate)
    batches = [pad_collate([data[i] for i in idx])
               for idx in loader.batch_sampler]
    tokens = [int((b[3] >= 0).sum()) for b in batches]
    print(f"    {n_params / 1e6:.3f} M parameters ({n_emb / 1e6:.3f} M in the "
          f"embeddings, {n_rnn / 1e6:.3f} M in the LSTMs); {len(data)} "
          f"samples, batches {[list(b[2].shape) for b in batches]}, target "
          f"tokens {tokens}")
    losses, begins, ends = [], [], []

    class Clock(paddle.callbacks.Callback):
        def on_train_batch_begin(self, step, logs=None):
            begins.append(time.perf_counter())

        def on_train_batch_end(self, step, logs=None):
            ends.append(time.perf_counter())
            losses.append(logs["loss"])
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model.fit(loader, epochs=S2S["epochs"], verbose=0, callbacks=[Clock()])
    peak = torch.cuda.max_memory_allocated()
    n = len(losses)
    check(n == S2S["epochs"] * len(batches), f"23b: {n} steps")
    check(all(np.isfinite(losses)), f"23b: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"23b: loss did not fall: {losses}")
    times = [(e - b) * 1e3 for b, e in zip(begins, ends)]
    step_ms = float(np.median(times[1:]))
    tok = [tokens[i % len(tokens)] for i in range(n)]
    tps = float(np.median([t / ms * 1e3 for t, ms in zip(tok[1:],
                                                          times[1:])]))
    print(f"    losses {[round(v, 4) for v in losses]}; step ms "
          f"{[round(v, 2) for v in times]}")
    print(f"    median step (steps 2-{n}) {step_ms:.2f} ms, "
          f"{S2S['batch'] / step_ms * 1e3:.1f} sequences/s, median "
          f"{tps:.1f} target tokens/s; the steps' own peak "
          f"{(peak - held) / 2**30:.3f} GiB over the {held / 2**30:.3f} GiB "
          f"held before them ({peak / 2**30:.3f} GiB in all)")
    rnn_profile(torch, model, batches[0], S2S["trg_vocab"])
    test = WMT16(mode="test", src_dict_size=S2S["src_vocab"],
                 trg_dict_size=S2S["trg_vocab"])
    ev = model.evaluate(paddle.io.DataLoader(
        test, batch_size=S2S["batch"], collate_fn=pad_collate), verbose=0)
    check(np.isfinite(ev["loss"]), f"23b: evaluate loss {ev}")
    print(f"    evaluate over WMT16(mode='test'), {len(test)} samples: loss "
          f"{ev['loss']:.4f}")
    return net


def beam_decode(paddle, net, src, steps, record=None):
    """ids [B, T, beam] of the beam search on ``net`` from ``src``;
    ``record`` collects each step's first beam + 1 candidates (their
    scores and flat indices, sorted)."""
    from paddle_tpu_torch.ops import search
    top_k = search.topk
    if record is not None:
        def recording(x, k):
            vals, idx = top_k(x, k + 1)
            record.append((vals.value.cpu(), idx.value.cpu()))
            return vals[:, :k], idx[:, :k]
        search.topk = recording
    try:
        net.eval()
        with paddle.no_grad():
            dec = paddle.nn.BeamSearchDecoder(
                net.decoder.cell, start_token=0, end_token=1,
                beam_size=S2S["beam"], embedding_fn=net.trg_emb,
                output_fn=net.head)
            ids, _ = paddle.nn.dynamic_decode(dec, inits=net.encode(src),
                                              max_step_num=steps)
        return ids.value
    finally:
        search.topk = top_k
        net.train()


def rnn_decode(torch, paddle, net):
    """23c: beam search at batch 128 on the trained weights, sequences/s;
    then 8 rows on the card and on a CPU twin of the same weights."""
    from paddle_tpu_torch.text.datasets import WMT16
    test = WMT16(mode="test", src_dict_size=S2S["src_vocab"],
                 trg_dict_size=S2S["trg_vocab"])
    src = pad_collate([test[i] for i in range(S2S["batch"])])[0]
    x = paddle.to_tensor(src)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = beam_decode(paddle, net, x, S2S["steps"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(list(ids.shape) == [S2S["batch"], S2S["steps"], S2S["beam"]],
          f"23c: ids {list(ids.shape)}")
    check(bool(((ids >= 0) & (ids < S2S["trg_vocab"])).all()),
          "23c: an id outside the vocabulary")
    wall = float(np.median(walls[1:]))
    print(f"    beam {S2S['beam']}, {S2S['steps']} steps, batch "
          f"{S2S['batch']}: {wall * 1e3:.1f} ms a decode (median of 2 after "
          f"one), {S2S['batch'] / wall:.1f} sequences/s")
    cpu = vision_on(paddle, "cpu", lambda: seq2seq_model(
        paddle, S2S["src_vocab"], S2S["trg_vocab"], S2S["hidden"],
        S2S["layers"], S2S["dropout"], S2S["init"]))
    cpu.set_state_dict({k: v.value.cpu() for k, v in net.state_dict().items()})
    rows = 8
    recs = [[], []]
    card_ids = beam_decode(paddle, net, paddle.to_tensor(src[:rows]),
                           S2S["steps"], recs[0]).cpu()
    cpu_ids = vision_on(paddle, "cpu", lambda: beam_decode(
        paddle, cpu, paddle.to_tensor(src[:rows]), S2S["steps"], recs[1]))
    # phase 5's rule: a row may part from the CPU's only at a step where,
    # on either side, two adjacent candidates among its first beam + 1
    # lie within BEAM_MARGIN; after that its beams hold other states
    same = (card_ids == cpu_ids).reshape(rows, -1).all(1)
    excused, first = torch.zeros(rows, dtype=torch.bool), {}
    k = S2S["beam"]
    for step, ((cv, ci), (pv, pi)) in enumerate(zip(*recs)):
        differ = (ci[:, :k] != pi[:, :k]).any(1)
        gaps = torch.cat([(v[:, :-1] - v[:, 1:]).abs() for v in (cv, pv)], 1)
        for r in torch.nonzero(differ).flatten().tolist():
            if r not in first:
                first[r] = step
                excused[r] = bool((gaps[r] < BEAM_MARGIN).any())
    bad = [r for r in range(rows) if not same[r] and not excused[r]]
    check(not bad, f"23c: rows {bad} part from the CPU's (first at steps "
          f"{[first.get(r) for r in bad]}) with no near-tie there")
    print(f"    {rows} rows card against CPU on the same weights: "
          f"{int(same.sum())} equal; the selections of {len(first)} part at "
          f"steps {sorted(first.values())}, each at a near-tie (adjacent "
          f"candidates within {BEAM_MARGIN})")


def rnn_card_vs_cpu(torch, paddle):
    """23d: the encoder-decoder at hidden 64, vocabularies 500 / 400, made
    from a seed on the CPU and carried to its card twin; 2 Adam steps in
    f32 with dropout 0: the losses and every grad (step 2's held to a CPU
    model at the card's point, as 22c's). Then DataLoader(num_workers=2)
    on the card against num_workers=0."""
    from paddle_tpu_torch.text.datasets import WMT16
    make = lambda: seq2seq_model(  # noqa: E731
        paddle, S2S["small_src"], S2S["small_trg"], S2S["small_hidden"],
        S2S["layers"], 0.0, S2S["init"])
    paddle.seed(7)
    cpu = vision_on(paddle, "cpu", make)
    card = vision_on(paddle, "cpu", make)
    card.set_state_dict({k: v.value for k, v in cpu.state_dict().items()})
    card.to(device="gpu")
    data = WMT16(mode="train", src_dict_size=S2S["small_src"],
                 trg_dict_size=S2S["small_trg"])
    batches = [pad_collate([data[i] for i in range(j * 32, j * 32 + 32)])
               for j in range(2)]
    crit = seq2seq_criterion(paddle)

    def grads(model, place, i):
        ts = [paddle.to_tensor(a, place=place) for a in batches[i]]
        loss = crit(model(*ts[:3]), ts[3])
        loss.backward()
        return float(loss.value.item()), {
            n: p.grad.value.detach().cpu() for n, p in
            model.named_parameters()}
    opts = [seq2seq_opt(paddle, card), seq2seq_opt(paddle, cpu)]
    gpu, cpu_place = paddle.CUDAPlace(0), paddle.CPUPlace()
    losses, got = [], []
    for i in range(2):
        if i == 1:
            there = vision_on(paddle, "cpu", make)
            there.set_state_dict({k: v.value.cpu() for k, v in
                                  card.state_dict().items()})
            at_card = grads(there, cpu_place, 1)
        step = [grads(card, gpu, i), grads(cpu, cpu_place, i)]
        for o in opts:
            o.step()
            o.clear_grad()
        losses.append([v for v, _ in step])
        got.append([g for _, g in step])
    for i, (a, b_) in enumerate(losses):
        check(abs(a - b_) <= LOSS_RTOL * abs(b_), f"23d: step {i + 1} loss "
              f"card {a} vs CPU {b_}")
    step1, w1 = rel_grads(torch, got[0][0], got[0][1], GRAD_TOL,
                          "23d step 1, card vs CPU")
    step2, w2 = rel_grads(torch, got[1][0], at_card[1], GRAD_TOL,
                          "23d step 2, card vs the CPU at the card's point")
    print(f"    hidden {S2S['small_hidden']}, vocabularies "
          f"{S2S['small_src']} / {S2S['small_trg']}, batch 32, 2 Adam steps: "
          f"losses card {[round(a, 6) for a, _ in losses]} vs CPU "
          f"{[round(b_, 6) for _, b_ in losses]} (rtol {LOSS_RTOL}); step 1's "
          f"grads within {step1:.3e} of their largest ({w1}), step 2's within "
          f"{step2:.3e} of the CPU's at the card's point ({w2}; tol "
          f"{GRAD_TOL})")
    plain = [[t.value for t in b] for b in paddle.io.DataLoader(
        data, batch_size=64, collate_fn=pad_collate)]
    workers = [[t.value for t in b] for b in paddle.io.DataLoader(
        data, batch_size=64, collate_fn=pad_collate, num_workers=2)]
    check(len(plain) == len(workers) and all(
        a.is_cuda and b.is_cuda and torch.equal(a, b)
        for pa, pb in zip(plain, workers) for a, b in zip(pa, pb)),
        "23d: DataLoader(num_workers=2) differs from num_workers=0")
    print(f"    DataLoader(WMT16, batch 64, num_workers=2) on the card: the "
          f"{len(plain)} batches of num_workers=0, on the card")


def phase_rnn(torch, amp):
    """Phase 23: the recurrent surface on the card. 23a the path's ops
    card against CPU and the RNNs' kernels; 23b the encoder-decoder at
    full width through Model.fit; 23c its beam decode; 23d a small one
    card against CPU and the DataLoader's workers. Returns its wall
    seconds."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as device_mod
    t0 = time.perf_counter()
    paddle.set_device("gpu")
    try:
        print("  [23a] the path's ops at its shapes, card against CPU, f32; "
              "the RNNs' kernels")
        rnn_ops(torch, paddle, amp)
        print(f"  [23b] the encoder-decoder through Model.fit: f32, batch "
              f"{S2S['batch']}, {S2S['epochs']} epochs")
        net = rnn_train(torch, paddle)
        print(f"  [23c] beam decode: beam {S2S['beam']}, batch "
              f"{S2S['batch']}")
        rnn_decode(torch, paddle, net)
        del net
        torch.cuda.empty_cache()
        print("  [23d] a small encoder-decoder card against CPU; the "
              "DataLoader's workers")
        rnn_card_vs_cpu(torch, paddle)
    finally:
        device_mod._current_place = None
    secs = time.perf_counter() - t0
    print(f"  phase 23 in {secs:.1f} s")
    return secs


# ---------------------------------------------------------------- phase 24

# phase 24: the reference's configs through jit.to_static, each run eager
# and captured in turns from the same seed and batch. A captured run's
# calls: 1 eager (warm-up), 2 eager under record, 3 capture + replay,
# then replays; its step ms is the median of calls 4..n (replays alone),
# an eager run's of calls 2..n
STATIC = dict(calls=10, small_calls=4, small_batch=2, lenet_calls=20,
              fit_samples=320, fit_batch=64, rule_calls=6)
# 24c, 24e: the eager step itself is not bit-reproducible on the card
# (two eager runs part: nondeterministic kernels, named by
# static_deterministic), so their runs compare within these (relative);
# then once more under torch.use_deterministic_algorithms, bit for bit
STATIC_TOL = dict(bert=1e-3, lenet=1e-6)


def static_loss(loss):
    """A step's loss as a Python float (a torch tensor or a port
    Tensor)."""
    v = loss.value if hasattr(loss, "value") else loss
    return float(v.detach().float().item())


def static_idle(torch, fn, args, n=3):
    """The card's idle share over ``n`` calls of ``fn(*args)`` under
    torch.profiler (the union of the device's kernels and copies against
    its window), or None where the profiler saw no device work."""
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from profile_port_serving import union_us
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return None
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    return 1 - union_us(spans) / window if window > 0 else None


def static_run(torch, build, calls, captured, wrappers=(), idle=True,
               snap=None, lazy=False):
    """``build()`` -> (step, args, keep) from the seed; ``calls`` calls of
    the step, through ``jit.to_static`` when ``captured``, else eagerly:
    lazily (FLAGS_lazy_eager, the default) when ``lazy``, otherwise on
    the immediate path (the flag False: phase 24's eager runs mean it).
    Returns the losses, each call's ms, the median step ms, the peak
    memory over what was held before, the idle share, the kernels'
    launches, ``snap(keep)`` taken before the idle share's profiled
    calls, for a captured run the capture ms, the pool's bytes and the
    graphs, and for a lazy one each call's flush forms."""
    import paddle_tpu_torch as paddle
    if not captured:
        paddle.set_flags({"FLAGS_lazy_eager": bool(lazy)})
    try:
        return _static_run(torch, build, calls, captured, wrappers, idle,
                           snap, lazy)
    finally:
        paddle.set_flags({"FLAGS_lazy_eager": True})


def _static_run(torch, build, calls, captured, wrappers, idle, snap,
                lazy):
    from paddle_tpu_torch.core import lazy as lazy_mod
    from paddle_tpu_torch.jit import to_static
    step, args, keep = build()
    fn = to_static(step) if captured else step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers:
        w.launches = 0
    losses, times, forms = [], [], []
    for _ in range(calls):
        seen = lazy_mod.flushes[0]
        t0 = time.perf_counter()
        loss = fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(static_loss(loss))
        forms.append(lazy_mod.forms_since(seen))
    res = dict(losses=losses, times=times, forms=forms,
               snap=snap(keep) if snap else None,
               peak=torch.cuda.max_memory_allocated() - held, held=held,
               launches=tuple(w.launches for w in wrappers),
               step_ms=float(np.median(times[3:] if captured or lazy
                                       else times[1:])))
    if captured:
        graphs = fn.graphs()
        res.update(capture_ms=graphs[0].capture_ms, pool=fn.pool_bytes(),
                   graphs=len(graphs),
                   replays=sum(g.replays for g in graphs))
    res["idle"] = static_idle(torch, fn, args) if idle else None
    return res


def static_report(label, runs, unit, per_step):
    """Print eager beside captured: step ms, ``unit``/s (``per_step`` of
    them a step), idle share, peak memory (and the pool), capture ms."""
    for r, captured in runs:
        idle = "not measured" if r["idle"] is None else f"{r['idle']:.4f}"
        extra = ""
        if captured:
            extra = (f"; graph pool {r['pool'] / 2**30:.3f} GiB, capture "
                     f"{r['capture_ms']:.1f} ms, {r['graphs']} graph(s), "
                     f"{r['replays']} replays")
        print(f"    {label} {'captured' if captured else 'eager':8s}: "
              f"step {r['step_ms']:.3f} ms "
              f"({per_step / r['step_ms'] * 1e3:.1f} {unit}/s), idle share "
              f"{idle}, peak {r['peak'] / 2**30:.3f} GiB over "
              f"{r['held'] / 2**30:.3f} held{extra}; calls ms "
              f"{[round(t, 2) for t in r['times']]}")


STATIC_PARTED = []     # (label, run, captured, calls, largest rel diff)


def static_same(label, runs, tol=0.0):
    """Every run's losses against the first's: bit for bit (``tol`` 0) or
    within ``tol`` relative. Prints every run's losses where they part
    and returns the parting calls, [] when none."""
    base = runs[0][0]["losses"]
    parted = []
    for k, (r, captured) in enumerate(runs[1:], 1):
        got = r["losses"]
        rel = [abs(a - b) / abs(b) for a, b in zip(got, base)]
        bad = [i for i, d in enumerate(rel) if d > tol]
        if bad:
            parted.append((label, k, captured, bad, max(rel)))
            kind = "captured" if captured else "eager"
            print(f"    {label}: run {k} ({kind}) parts from run 0 (eager) "
                  f"at calls {bad}, at most {max(rel):.3e} relative: {got} "
                  f"vs {base}")
    if not parted:
        worst = max((abs(a - b) / abs(b) for r, _ in runs[1:]
                     for a, b in zip(r["losses"], base)), default=0.0)
        print(f"    {label}: losses {[round(v, 6) for v in base]}, "
              + ("every run's bits the same" if tol == 0.0 else
                 f"every run within {worst:.3e} relative of run 0 (tol "
                 f"{tol})"))
    STATIC_PARTED.extend(parted)
    return parted


@contextlib.contextmanager
def static_deterministic(torch, label):
    """Run the block under torch.use_deterministic_algorithms(True,
    warn_only=True) (cuDNN's deterministic algorithms too) and print the
    ops torch flags as nondeterministic on the way."""
    import warnings
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
    names = sorted({str(w.message).splitlines()[0][:160] for w in caught
                    if "determinis" in str(w.message)})
    print(f"    {label}, torch's deterministic algorithms: ops flagged: "
          + (" | ".join(names) if names else "none"))


def static_grad_parts(torch, label, loss_fn, named, n=5):
    """``n`` forward and backward passes of ``loss_fn()`` from one state,
    eager: the parameters whose grads part from the first pass's, each
    with its largest difference over its largest grad. Names where
    eager's own nondeterminism lies."""
    grads = []
    for _ in range(n):
        for _, p in named:
            p.grad = None
        loss_fn().backward()
        grads.append({k: p.grad.detach().float().clone() for k, p in named
                      if p.grad is not None})
    parted = {}
    for g in grads[1:]:
        for k, v in g.items():
            if not torch.equal(v, grads[0][k]):
                d = float(((v - grads[0][k]).abs().max()
                           / grads[0][k].abs().max().clamp_min(1e-30)).item())
                parted[k] = max(parted.get(k, 0.0), d)
    for _, p in named:
        p.grad = None
    print(f"    {label}: {n} eager backward passes from one state: "
          + (f"{len(parted)} of {len(grads[0])} grads part: " + ", ".join(
              f"{k} {d:.2e}" for k, d in sorted(parted.items(),
                                                 key=lambda kv: -kv[1]))
             if parted else f"all {len(grads[0])} grads the same bits"))
    return parted


def static_repeats(torch, label, fn, n=20):
    """How many distinct values ``fn()`` gives over ``n`` calls on one
    state: 1 where the computation is deterministic on the card."""
    vals = []
    for _ in range(n):
        vals.append(float(fn().float().item()))
    distinct = sorted(set(vals))
    print(f"    {label}: {len(distinct)} distinct value(s) over {n} calls"
          + ("" if len(distinct) == 1 else
             f", {distinct[0]!r} .. {distinct[-1]!r}"))
    return len(distinct)


def static_kernels(torch, attn, tce, amp, optimizer, TransformerLMConfig):
    """24a: a 2-layer GPT at full width (768, 12 heads, vocab 50304),
    [2, 1024], forward and backward captured, AdamW eager outside the
    step: untied and tied, f32 and O1 bf16. Each call's loss and every
    grad the eager run's bits; launches eager = captured (captured x
    replays + the eager calls)."""
    from paddle_tpu_torch.jit import to_static
    from paddle_tpu_torch.text.models import GPTForCausalLM
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv, tce.fused_ce_forward, tce.fused_ce_bwd_dx,
                tce.fused_ce_bwd_dw)
    calls, b, seq = STATIC["small_calls"], STATIC["small_batch"], \
        FLAGSHIP["seq"]
    ids = torch.from_numpy(np.random.RandomState(24).randint(
        0, 50304, (b, seq)).astype(np.int64)).cuda()
    for tie, dtype in ((False, "float32"), (False, "bfloat16"),
                       (True, "float32"), (True, "bfloat16")):
        cfg = TransformerLMConfig(num_layers=2, dropout=0.0,
                                  use_flash_attention=True, max_seq_len=seq,
                                  tie_embeddings=tie)
        runs = []
        for captured in (False, True):
            model = GPTForCausalLM(cfg, generator=torch.Generator(
                ).manual_seed(24)).train()
            opt = optimizer.AdamW(1e-4, parameters=model.named_parameters(),
                                  weight_decay=0.01)

            def fwd_bwd(ids, model=model):
                with amp.auto_cast(enable=dtype == "bfloat16", level="O1",
                                   dtype="bfloat16"):
                    loss = model(ids, labels=ids)
                loss.backward()
                return loss
            fn = to_static(fwd_bwd) if captured else fwd_bwd
            for w in wrappers:
                w.launches = 0
            losses, grads = [], []
            for _ in range(calls):
                loss = fn(ids)
                grads.append([p.grad.detach().clone()
                              for _, p in model.named_parameters()])
                opt.step()
                opt.clear_grad()
                losses.append(loss.item())
            runs.append((losses, grads, tuple(w.launches for w in wrappers)))
            del model, opt, fn
        (el, eg, ec), (cl, cg, cc) = runs
        label = f"24a {'tied' if tie else 'untied'} {dtype}"
        check(el == cl, f"{label}: captured losses {cl} != eager {el}")
        bad = [i for i, (a, c) in enumerate(zip(eg, cg))
               if not all(torch.equal(x, y) for x, y in zip(a, c))]
        check(not bad, f"{label}: grads differ from eager's at calls {bad}")
        want = (calls * cfg.num_layers,) * 3 + ((calls,) * 3 if tie
                                                else (0, 0, 0))
        check(ec == want and cc == want,
              f"{label}: launches eager {ec}, captured {cc}, want {want}")
        print(f"    {label}: {calls} calls (2 eager, capture + replay, "
              f"replay): losses {[round(v, 6) for v in cl]} and all "
              f"{len(eg[0])} grads the eager run's bits; K1/K2/K3/K5/K6/K7 "
              f"launches {cc}")
        del runs, eg, cg
        torch.cuda.empty_cache()


def static_resnet(torch, paddle, amp):
    """24b: the reference's config 2 as bench.py:186-206 writes it, through
    jit.to_static: resnet50(1000) from paddle.seed(0), Momentum(0.1, 0.9,
    1e-4), O2 bf16, 128 x [3, 224, 224] from RandomState(0); eager,
    captured, eager, captured, STATIC['calls'] calls each: the losses and
    the 53 batch norms' running statistics bit for bit."""
    from paddle_tpu_torch.vision import models
    b, s = RESNET["batch"], RESNET["size"]

    def build():
        paddle.seed(0)
        net = models.resnet50(num_classes=RESNET["classes"])
        opt = paddle.optimizer.Momentum(0.1, momentum=0.9,
                                        parameters=net.parameters(),
                                        weight_decay=1e-4)
        loss_fn = paddle.nn.CrossEntropyLoss()
        rs = np.random.RandomState(0)
        x = paddle.to_tensor(rs.randn(b, 3, s, s).astype("float32"))
        y = paddle.to_tensor(rs.randint(0, RESNET["classes"], (b,)).astype(
            "int64"))

        def train_step_fn(x, y):
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                out = net(x)
                loss = loss_fn(out, y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return train_step_fn, (x, y), net

    def stats(net):
        return [(m._mean.value.clone(), m._variance.value.clone())
                for m in net.sublayers()
                if type(m).__name__ == "BatchNorm2D"]

    runs = []
    for captured in (False, True, False, True):
        r = static_run(torch, build, STATIC["calls"], captured,
                       idle=len(runs) >= 2, snap=stats)
        runs.append((r, captured))
        torch.cuda.empty_cache()
    static_same("24b ResNet-50 O2", runs)
    base = runs[0][0]["snap"]
    for r, captured in runs[1:]:
        bad = [i for i, ((a, b_), (c, d)) in enumerate(zip(base, r["snap"]))
               if not (torch.equal(a, c) and torch.equal(b_, d))]
        check(len(base) == 53 and not bad,
              f"24b: {len(base)} batch norms, statistics differ at {bad}")
        r["snap"] = None
    print(f"    24b: all {len(base)} batch norms' running mean and variance "
          f"after {STATIC['calls']} calls the same bits in every run")
    static_report("24b ResNet-50 O2", runs[2:], "samples", b)


def static_bert(torch, amp, optimizer, attn):
    """24c: config 3 (tools/baseline_bench.py:87-107) through
    jit.to_static: bert_base(max_seq_len=128, dropout=0.0), AdamW(1e-4,
    weight_decay 0.01), O1 bf16, bench_bert's batch 32 x 128; eager,
    captured, eager, captured: losses bit for bit, the non-causal bf16
    K1-K3 = 12 a call."""
    from paddle_tpu_torch.text.models import bert_base
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv)

    def build():
        model = bert_base(max_seq_len=BERT["seq"], dropout=0.0,
                          generator=torch.Generator().manual_seed(0)).train()
        opt = optimizer.AdamW(1e-4, parameters=model.named_parameters(),
                              weight_decay=0.01)
        batch = [torch.from_numpy(a).cuda() for a in
                 bert_data(BERT["batch"], BERT["seq"],
                           model.cfg.vocab_size)]

        def step_fn(ids, tok, mlm, nsp):
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = model(ids, tok, mlm, nsp)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return step_fn, batch, model

    runs = []
    for captured in (False, True, False, True):
        r = static_run(torch, build, STATIC["calls"], captured, wrappers,
                       idle=len(runs) >= 2)
        runs.append((r, captured))
        want = (STATIC["calls"] * 12,) * 3
        check(r["launches"] == want,
              f"24c: K1/K2/K3 launches {r['launches']}, want {want}")
        torch.cuda.empty_cache()
    static_same("24c BERT-base O1", runs, STATIC_TOL["bert"])
    static_report("24c BERT-base O1", runs[2:], "samples", BERT["batch"])
    with static_deterministic(torch, "24c BERT-base O1"):
        det = [(static_run(torch, build, STATIC["calls"], c, idle=False), c)
               for c in (False, True)]
    static_same("24c BERT-base O1 under deterministic algorithms", det)
    # one fixed state, eager: the forward's own repeatability
    step, batch, model = build()
    with torch.no_grad():
        def fwd():
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                return model(*batch)
        static_repeats(torch, "24c BERT-base O1 forward loss, eager", fwd)
    static_grad_parts(torch, "24c BERT-base O1", fwd,
                      list(model.named_parameters()))
    del step, batch, model
    return tuple(sum(r["launches"][i] for r, c in runs if c)
                 for i in range(3))


def static_flagship(torch, attn, tce, amp, optimizer, TransformerLMConfig):
    """24d: the flagship (tools/baseline_bench.py:163-197) through
    jit.to_static: tied GPT-124M, 8 x 1024, O1 bf16, AdamW(1e-4,
    weight_decay 0.01); eager, captured, eager, captured: losses bit for
    bit, K1-K3 = 12 and K5-K7 = 1 a call."""
    from paddle_tpu_torch.text.models import GPTForCausalLM
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv, tce.fused_ce_forward, tce.fused_ce_bwd_dx,
                tce.fused_ce_bwd_dw)
    cfg = TransformerLMConfig(dropout=0.0, use_flash_attention=True,
                              max_seq_len=FLAGSHIP["seq"])

    def build():
        model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
            1234)).train()
        opt = optimizer.AdamW(1e-4, parameters=model.named_parameters(),
                              weight_decay=0.01)
        ids = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (FLAGSHIP["batch"], FLAGSHIP["seq"])).astype(
                np.int64)).cuda()

        def step_fn(ids, labels):
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = model(ids, labels=labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return step_fn, (ids, ids), model

    runs = []
    for captured in (False, True, False, True):
        r = static_run(torch, build, STATIC["calls"], captured, wrappers,
                       idle=len(runs) >= 2)
        runs.append((r, captured))
        want = (STATIC["calls"] * cfg.num_layers,) * 3 + \
            (STATIC["calls"],) * 3
        check(r["launches"] == want,
              f"24d: launches {r['launches']}, want {want}")
        torch.cuda.empty_cache()
    static_same("24d flagship GPT-124M O1", runs)
    static_report("24d flagship GPT-124M O1", runs[2:], "tokens",
                  FLAGSHIP["batch"] * FLAGSHIP["seq"])
    return tuple(sum(r["launches"][i] for r, c in runs if c)
                 for i in range(6))


def static_lenet(torch, paddle):
    """24e: config 1 (tools/baseline_bench.py:27-82): LeNet, Adam 1e-3,
    batch 64, the step closing over its batch, eager against captured;
    then Model.fit on LeNet after enable_static() against the dygraph
    fit, both under deterministic algorithms: every batch's loss,
    evaluate and predict."""
    from paddle_tpu_torch.vision import models
    b = LENET["batch"]

    def build():
        paddle.seed(0)
        net = models.LeNet()
        opt = paddle.optimizer.Adam(1e-3, parameters=net.parameters())
        loss_fn = paddle.nn.CrossEntropyLoss()
        rs = np.random.RandomState(1)
        x = paddle.to_tensor(rs.randn(b, 1, 28, 28).astype("float32"))
        y = paddle.to_tensor(rs.randint(0, 10, (b,)).astype("int64"))

        def step():
            loss = loss_fn(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return step, (), net

    runs = []
    for captured in (False, True, False, True):
        r = static_run(torch, build, STATIC["lenet_calls"], captured,
                       idle=len(runs) >= 2)
        runs.append((r, captured))
    static_same("24e LeNet config 1", runs, STATIC_TOL["lenet"])
    static_report("24e LeNet config 1", runs[2:], "samples", b)
    with static_deterministic(torch, "24e LeNet config 1"):
        det = [(static_run(torch, build, STATIC["lenet_calls"], c,
                           idle=False), c) for c in (False, True)]
    static_same("24e LeNet config 1 under deterministic algorithms", det)
    paddle.seed(0)
    net = models.LeNet()
    rs = np.random.RandomState(1)
    x = paddle.to_tensor(rs.randn(b, 1, 28, 28).astype("float32"))
    y = paddle.to_tensor(rs.randint(0, 10, (b,)).astype("int64"))
    static_grad_parts(torch, "24e LeNet config 1",
                      lambda: paddle.nn.CrossEntropyLoss()(net(x), y).value,
                      [(k, p.value) for k, p in net.named_parameters()])
    del net, x, y

    n = STATIC["fit_samples"]
    rs = np.random.RandomState(2)
    xs = rs.randn(n, 1, 28, 28).astype("float32")
    ys = rs.randint(0, 10, (n, 1)).astype("int64")

    class Arrays(paddle.io.Dataset):
        def __getitem__(self, i):
            return xs[i], ys[i]

        def __len__(self):
            return n

    def fit(static):
        paddle.seed(0)
        net = models.LeNet()
        model = paddle.Model(net)
        model.prepare(paddle.optimizer.Adam(1e-3,
                                            parameters=net.parameters()),
                      paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
        seen, times = [], []

        class Rec(paddle.callbacks.Callback):
            def on_train_batch_begin(self, step, logs=None):
                self.t0 = time.perf_counter()

            def on_train_batch_end(self, step, logs=None):
                times.append((time.perf_counter() - self.t0) * 1e3)
                seen.append(logs["loss"])
        if static:
            paddle.enable_static()
        try:
            model.fit(Arrays(), batch_size=STATIC["fit_batch"], epochs=2,
                      verbose=0, shuffle=False, callbacks=[Rec()])
            ev = model.evaluate(Arrays(), batch_size=STATIC["fit_batch"],
                                verbose=0)
            pred = model.predict(Arrays(), batch_size=STATIC["fit_batch"],
                                 stack_outputs=True, verbose=0)[0]
            graphs = sum(len(s.graphs()) for s in
                         model._static_steps.values())
        finally:
            paddle.disable_static()
        return seen, ev, pred, times, graphs

    with static_deterministic(torch, "24e Model.fit, dygraph and static"):
        fits = [fit(False), fit(True)]
    (dl, dev_, dp, dt, _), (sl, sev, sp, st, graphs) = fits
    check(sl == dl, f"24e: static fit losses {sl} != dygraph {dl}")
    check(sev == dev_ and np.array_equal(sp, dp),
          f"24e: static evaluate {sev} / predict differ from dygraph's "
          f"{dev_}")
    print(f"    24e Model.fit on LeNet after enable_static(), under "
          f"deterministic algorithms: {len(sl)} batches' losses, evaluate "
          f"{sev} and predict the dygraph fit's bits; {graphs} graphs "
          f"(train, eval, predict); train_batch ms "
          f"dygraph {float(np.median(dt[1:])):.3f}, static (replays) "
          f"{float(np.median(st[3:])):.3f}")


def static_rules(torch, paddle, amp):
    """24f: an LR schedule stepped between replays gives the eager
    trajectory; dropout masks differ on every replay; a float(), an
    .item(), a Tensor `if` no dy2static conversion reached
    (enable_ast=False, an unconverted callee), a GradScaler and a
    rebinding inside a captured step raise ToStaticError, and the card
    works on after."""
    from paddle_tpu_torch.jit import ToStaticError, to_static
    calls = STATIC["rule_calls"]
    runs = []
    for captured in (False, True):
        paddle.seed(5)
        lin = paddle.nn.Linear(64, 64)
        sched = paddle.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
        opt = paddle.optimizer.SGD(sched, parameters=lin.parameters())
        rs = np.random.RandomState(5)
        x = paddle.to_tensor(rs.randn(32, 64).astype("float32"))
        y = paddle.to_tensor(rs.randn(32, 64).astype("float32"))

        def step(x, y):
            loss = paddle.nn.functional.mse_loss(lin(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        fn = to_static(step) if captured else step
        losses, lrs = [], []
        for _ in range(calls):
            losses.append(static_loss(fn(x, y)))
            sched.step()
            lrs.append(opt.get_lr())
        runs.append((losses, lrs, lin.weight.value.clone()))
    (el, elr, ew), (cl, clr, cw) = runs
    check(el == cl and elr == clr and torch.equal(ew, cw),
          f"24f: StepDecay captured {cl} vs eager {el}")
    print(f"    24f StepDecay(0.1, 2, 0.5) stepped between {calls} calls: "
          f"the captured losses {[round(v, 6) for v in cl]} and weights "
          f"the eager run's bits (rates {clr})")

    paddle.seed(11)
    drop = to_static(lambda x: paddle.nn.functional.dropout(
        x, p=0.5, training=True))
    x = paddle.ones([1 << 16])
    masks = [drop(x).value.clone() for _ in range(calls)]
    same = [(i, j) for i in range(calls) for j in range(i)
            if torch.equal(masks[i], masks[j])]
    keep = [float((m != 0).float().mean().item()) for m in masks]
    check(not same and all(abs(k - 0.5) < 0.01 for k in keep),
          f"24f: dropout masks repeat at {same}, keep shares {keep}")
    print(f"    24f dropout(0.5) over {calls} calls (2 eager, then "
          f"replays): no two masks alike, keep shares "
          f"{[round(k, 4) for k in keep]}")

    xt = paddle.ones([256])
    xr = torch.ones(256, device="cuda")
    w = paddle.ones([4])
    w.stop_gradient = False
    h = w * 2
    scaler = paddle.amp.GradScaler()

    def host_float(x):
        loss = (x * 2).sum()
        return loss * float(loss)

    def host_item(x):
        s = (x * 2).sum()
        return s * s.item()

    def tensor_if(x):
        if (x * 2).sum() > 0:
            return x * 2
        return x

    def calls_tensor_if(x):
        return tensor_if(x) + 1

    def scaled(x):
        return scaler.scale((x * 2).sum())

    def rebinds(x):
        h.stop_gradient = True
        return x + 1
    # a Tensor `if` that dy2static converts captures (phase 25a); one
    # it does not reach still raises: with enable_ast=False, and in a
    # callee of the converted function
    cases = (("float() of a Tensor", host_float, xt, "host read", True),
             ("torch .item()", host_item, xr, "capturing the step", True),
             ("a Tensor if with enable_ast=False", tensor_if, xt,
              "dy2static", False),
             ("a Tensor if in an unconverted callee", calls_tensor_if, xt,
              "dy2static", True),
             ("a GradScaler", scaled, xr, "GradScaler", True),
             ("a rebinding", rebinds, xt, "rebinds", True))
    for label, fn, arg, word, ast_on in cases:
        traced = to_static(fn, warmup=0, enable_ast=ast_on)
        try:
            for _ in range(3):
                traced(arg)
        except ToStaticError as e:
            check(word in str(e), f"24f: {label}: {e}")
            torch.cuda.synchronize()
            ok = float((xr + 1).sum().item())
            check(ok == 512.0, f"24f: the card after {label}: {ok}")
            print(f"    24f {label} inside the step: ToStaticError "
                  f"({str(e)[:90]}...); eager work goes on")
            continue
        raise SmokeFailure(f"24f: {label} inside a captured step did not "
                           "raise")


def static_distribution(torch, paddle):
    """24g: distribution on the card: Normal, Uniform and
    MultivariateNormalDiag samples (1M draws) hold their mean and
    standard deviation within 6 standard errors, a Categorical's and
    sampling_id's frequencies pass a chi-square at p = 0.001; each
    log_prob, entropy and KL on the card within 1e-5 relative (1e-6
    absolute) of the same on the CPU."""
    D = paddle.distribution
    n = 1 << 20
    paddle.seed(24)

    def moments(x, mean, std, label):
        x = x.value.double()
        m, sd = float(x.mean().item()), float(x.std().item())
        se = std / np.sqrt(x.numel())
        check(abs(m - mean) < 6 * se and abs(sd - std) < 6 * se * 0.7072,
              f"24g: {label}: mean {m} (want {mean}), std {sd} (want {std})")
        return f"{label} mean {m:.5f} std {sd:.5f}"
    seen = [moments(D.Normal(1.5, 2.0).sample([n]), 1.5, 2.0, "Normal"),
            moments(D.Uniform(-1.0, 3.0).sample([n]), 1.0, 4 / np.sqrt(12),
                    "Uniform")]
    mvn = D.MultivariateNormalDiag(np.zeros(2, "float32"),
                                   np.diag([1.0, 9.0]).astype("float32"))
    x = mvn.sample((n,))
    check(x.value.is_cuda, "24g: the MultivariateNormalDiag sample is not "
          "on the card")
    for j, sd in enumerate((1.0, 3.0)):
        seen.append(moments(paddle.Tensor._wrap(x.value[:, j]), 0.0, sd,
                            f"MVN[{j}]"))
    probs = np.array([0.1, 0.2, 0.3, 0.4], "float32")
    for label, draws in (
            ("Categorical", D.Categorical(np.log(probs)).sample([n])),
            ("sampling_id", D.sampling_id(np.tile(probs, (1 << 16, 1))))):
        counts = np.bincount(draws.numpy().reshape(-1), minlength=4)
        expect = counts.sum() * probs
        chi2 = float(((counts - expect) ** 2 / expect).sum())
        check(chi2 < 16.27, f"24g: {label} chi-square {chi2}: {counts}")
        seen.append(f"{label} chi-square {chi2:.2f}")
    rs = np.random.RandomState(24)
    loc, loc2, val = (rs.randn(64, 16).astype("float32") for _ in range(3))
    sc, sc2 = ((rs.rand(64, 16) + 0.5).astype("float32") for _ in range(2))
    logits = rs.randn(64, 50).astype("float32")
    idx = rs.randint(0, 50, (64,)).astype("int64")
    cov = np.diag((rs.rand(16) + 0.5).astype("float32"))
    worst = 0.0
    outs = {}
    for place in ("cpu", "cuda"):
        def T(a):
            return paddle.to_tensor(a, place=place)
        nd, nd2 = D.Normal(T(loc), T(sc)), D.Normal(T(loc2), T(sc2))
        ud = D.Uniform(T(loc), T(loc + sc))
        cd = D.Categorical(T(logits))
        md = D.MultivariateNormalDiag(T(loc), T(cov))
        outs[place] = [nd.log_prob(T(val)), nd.entropy(),
                       nd.kl_divergence(nd2),
                       ud.log_prob(T(loc + 0.5 * sc)), ud.entropy(),
                       cd.log_prob(T(idx)), cd.entropy(), md.log_prob(T(val)),
                       md.entropy(),
                       md.kl_divergence(D.MultivariateNormalDiag(
                           T(loc2), T(cov)))]
    for a, b in zip(outs["cpu"], outs["cuda"]):
        a, b = a.numpy(), b.numpy()
        err = float(np.max(np.abs(a - b) - 1e-5 * np.abs(a)))
        check(err <= 1e-6, f"24g: card vs CPU {err}")
        worst = max(worst, float(np.max(np.abs(a - b) / np.maximum(
            np.abs(a), 1e-6))))
    print(f"    24g {'; '.join(seen)}; {len(outs['cpu'])} log_prob / "
          f"entropy / KL outputs card vs CPU within {worst:.3e} relative")


def phase_static(torch, attn, tce, amp, optimizer, TransformerLMConfig):
    """Phase 24: jit.to_static on the card (24a-24f), and distribution
    (24g). Returns the
    captured runs' launches: 24c's (K1, K2, K3) and 24d's six."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as device_mod
    t0 = time.perf_counter()
    print("  [24a] K1-K3 and K5-K7 inside a graph: a 2-layer GPT at full "
          "width, forward and backward captured")
    static_kernels(torch, attn, tce, amp, optimizer, TransformerLMConfig)
    print("  [24c] config 3: BERT-base O1 bf16, 32 x 128, captured")
    bert = static_bert(torch, amp, optimizer, attn)
    print("  [24d] the flagship: tied GPT-124M O1 bf16, 8 x 1024, captured")
    flagship = static_flagship(torch, attn, tce, amp, optimizer,
                               TransformerLMConfig)
    paddle.set_device("gpu")
    try:
        print("  [24b] config 2: ResNet-50 O2 bf16, Momentum, batch "
              f"{RESNET['batch']}, captured")
        static_resnet(torch, paddle, amp)
        print("  [24e] config 1: LeNet captured; Model.fit after "
              "enable_static()")
        static_lenet(torch, paddle)
        print("  [24f] the rules: an LR schedule, dropout masks, what "
              "raises")
        static_rules(torch, paddle, amp)
        print("  [24g] distribution on the card: samples' moments, "
              "log_prob / entropy / KL against the CPU")
        static_distribution(torch, paddle)
    finally:
        device_mod._current_place = None
    print(f"  phase 24 in {time.perf_counter() - t0:.1f} s")
    check(not STATIC_PARTED, f"24: losses parted from the eager run's: "
          f"{STATIC_PARTED}")
    return bert, flagship


# -- phase 25: dy2static and the static graph on the card -------------------

DY2 = dict(calls=8, flagship_calls=10, program_steps=10)
# 25a's card against CPU: the same f32 ops, summed in another order
DY2_TOL = 1e-5


def dy2_cases(P):
    """25a's steps, each converted by to_static, with the arguments of
    each call (numpy): the data changes the branch taken and the trip
    count from call to call, never a shape."""
    def if_elif(x):
        s = x.sum()
        if s > 10.0:
            return x * 10.0
        elif s > 0.0:
            return x * 1.0
        else:
            return x * -1.0

    def guards(x, y):
        if x.max() > 100.0:
            return x
        z = x + y
        if z.sum() > 0:
            if z.max() > 3.0:
                return z * 4.0
            return z * 2.0
        return z * -1.0

    def tensor_while(x, n):
        s = x * 0.0
        i = P.zeros([], dtype="int64")
        while i < n:
            s = s + x
            i = i + 1
        return s

    def for_break_continue(x, n, cap):
        s = x * 0.0
        t = P.zeros([], dtype="float32")
        for i in range(n):
            t = t + 1.0
            if P.sum(t % 2.0) > 0.5:
                continue
            if s.sum() >= cap:
                break
            s = s + x
        return s

    def rows(m, thr):
        s = m[0] * 0.0
        for row in m:
            if row.sum() > thr:
                s = s + row
        return s

    def loop_return(n, x):
        for _i in range(n):
            x = x + 1.0
            if x.sum() > 6.0:
                return x
        return x * 10.0

    def logic(x, y):
        if (x.sum() > 0 and x.max() < 5.0) or not y.sum() > 0:
            z = x + y
        else:
            z = x - y
        return z

    def guarded_index(x, idx):
        # in range only where the predicate holds: the other branch must
        # never run (an index past the end is a device-side assert)
        if idx < 4:
            out = P.gather(x, idx)
        else:
            out = x[:1] * 0.0 - 7.0
        return out

    f32 = np.float32
    rs = np.random.RandomState(25)
    vec = [np.full(3, v, f32) for v in (5.0, 0.5, -2.0, 5.0, -2.0, 0.5,
                                         -2.0, 5.0)]
    n = [np.int64(v) for v in (3, 0, 7, 1, 5, 2, 9, 4)]
    sign = [1.0, -1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0]
    return (
        ("if/elif/else", if_elif, [(v,) for v in vec]),
        ("guard clauses, nested returns", guards,
         [(v * sg, np.full(3, 0.8, f32) * sg) for v, sg in zip(vec, sign)]),
        ("a Tensor while", tensor_while,
         [(np.arange(3, dtype=f32), k) for k in n]),
        ("a Tensor-bounded for, break and continue", for_break_continue,
         [(np.ones(4, f32), np.int64(k), f32(c)) for k, c in
          zip((10, 3, 20, 0, 7, 12, 5, 30), (8.0, 2.0, 20.0, 4.0, 100.0,
                                             6.0, 0.0, 12.0))]),
        ("for over Tensor rows", rows,
         [(rs.randn(6, 3).astype(f32), f32(t)) for t in
          (0.0, 1.0, -1.0, 0.5, 9.0, -9.0, 0.2, -0.3)]),
        ("a return inside a loop", loop_return,
         [(np.int64(k), np.full(3, v, f32)) for k, v in
          ((5, 1.0), (1, 0.0), (3, 0.0), (8, 1.5), (0, 2.0), (2, 1.0),
           (6, -1.0), (4, 0.5))]),
        ("and/or/not", logic,
         [(v * sg, np.full(3, 0.5, f32) * -sg) for v, sg in
          zip(vec, sign)]),
        ("an untaken branch out of range", guarded_index,
         [(np.arange(4, dtype=f32) + 1, np.array([i], np.int64)) for i in
          (0, 9, 2, 11, 3, 7, 1, 100)]),
    )


def dy2_cases_run(torch, paddle):
    """25a: each case through jit.to_static on CUDA tensors, against the
    same converted function eagerly on the CPU; one graph a case, its
    replays following the data."""
    from paddle_tpu_torch.jit import dy2static, to_static
    calls = DY2["calls"]
    for label, fn, arg_sets in dy2_cases(paddle):
        check(len(arg_sets) == calls, f"25a {label}: {len(arg_sets)} calls")
        traced = to_static(fn)
        twin = dy2static.convert_to_static(fn)
        outs = []
        for args in arg_sets:
            paddle.set_device("cpu")
            want = twin(*[paddle.to_tensor(a) for a in args]).numpy()
            paddle.set_device("gpu")
            got = traced(*[paddle.to_tensor(a) for a in args])
            torch.cuda.synchronize()
            got = got.numpy()
            err = float(np.abs(got - want).max()) if got.size else 0.0
            top = max(float(np.abs(want).max()) if want.size else 0.0, 1.0)
            check(got.shape == want.shape and err <= DY2_TOL * top,
                  f"25a {label}: card {got} vs CPU {want}")
            outs.append(got)
        graphs = traced.graphs()
        replays = sum(g.replays for g in graphs)
        check(len(graphs) == 1 and replays == calls - 2,
              f"25a {label}: {len(graphs)} graphs, {replays} replays")
        distinct = len({o.tobytes() for o in outs})
        print(f"    25a {label}: {calls} calls on the card = the CPU's "
              f"eager run (within {DY2_TOL:g} of the largest value), one "
              f"graph, {replays} replays, {distinct} distinct outputs")


def dy2_flagship(torch, attn, tce, amp, optimizer, TransformerLMConfig,
                 paddle):
    """25b: phase 24d's flagship step (tied GPT-124M, 8 x 1024, O1 bf16,
    AdamW) with a loss-spike guard as dy2static writes it, a Tensor `if`
    on the detached loss against a 0-d Tensor argument that alternates
    between calls (0: scale 0.5; 1e9: scale 1.0): eager against
    captured over 10 calls, losses and weights bit for bit, one graph,
    K1-K3 = 12 and K5-K7 = 1 a call. Returns the captured run's six
    launches."""
    from paddle_tpu_torch.jit import to_static
    from paddle_tpu_torch.text.models import GPTForCausalLM
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv, tce.fused_ce_forward, tce.fused_ce_bwd_dx,
                tce.fused_ce_bwd_dw)
    cfg = TransformerLMConfig(dropout=0.0, use_flash_attention=True,
                              max_seq_len=FLAGSHIP["seq"])
    calls = DY2["flagship_calls"]
    spikes = [0.0 if i % 2 == 0 else 1e9 for i in range(calls)]
    runs = []
    for captured in (False, True):
        model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
            1234)).train()
        opt = optimizer.AdamW(1e-4, parameters=model.named_parameters(),
                              weight_decay=0.01)
        ids = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, (FLAGSHIP["batch"], FLAGSHIP["seq"])).astype(
                np.int64)).cuda()
        spike = paddle.to_tensor(np.float32(0.0))

        def step_fn(ids, labels, spike):
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                loss = model(ids, labels=labels)
            if loss.detach() > spike:
                scale = 0.5
            else:
                scale = 1.0
            (loss * scale).backward()
            opt.step()
            opt.clear_grad()
            return loss

        fn = to_static(step_fn) if captured else step_fn
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers:
            w.launches = 0
        losses, times = [], []
        for v in spikes:
            spike.set_value(np.float32(v))
            t0 = time.perf_counter()
            loss = fn(ids, ids, spike)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(static_loss(loss))
        r = dict(losses=losses, times=times,
                 peak=torch.cuda.max_memory_allocated() - held, held=held,
                 launches=tuple(w.launches for w in wrappers),
                 weights=[p.detach().clone() for p in model.parameters()],
                 step_ms=float(np.median(times[3:] if captured
                                         else times[1:])))
        want = (calls * cfg.num_layers,) * 3 + (calls,) * 3
        check(r["launches"] == want,
              f"25b: launches {r['launches']}, want {want}")
        if captured:
            graphs = fn.graphs()
            r.update(capture_ms=graphs[0].capture_ms, pool=fn.pool_bytes(),
                     graphs=len(graphs),
                     replays=sum(g.replays for g in graphs))
            check(r["graphs"] == 1 and r["replays"] == calls - 2,
                  f"25b: {r['graphs']} graphs, {r['replays']} replays")
        r["idle"] = static_idle(torch, fn, (ids, ids, spike))
        runs.append((r, captured))
        del model, opt, fn
        torch.cuda.empty_cache()
    (eager, _), (capt, _) = runs
    same_w = all(torch.equal(a, b) for a, b in zip(eager["weights"],
                                                   capt["weights"]))
    check(eager["losses"] == capt["losses"] and same_w,
          f"25b: captured losses {capt['losses']} vs eager "
          f"{eager['losses']}; weights the same: {same_w}")
    print(f"    25b losses {[round(v, 6) for v in eager['losses']]}: "
          f"captured = eager bit for bit, and every weight after "
          f"{calls} calls; the guard took scale "
          f"{[0.5 if v < 1 else 1.0 for v in spikes]} (a branch a call, "
          f"one graph)")
    for r, _ in runs:
        r.pop("weights")
    static_report("25b flagship GPT-124M O1 + Tensor if", runs, "tokens",
                  FLAGSHIP["batch"] * FLAGSHIP["seq"])
    return capt["launches"]


def dy2_program(torch, attn, TransformerLMConfig, paddle):
    """25c: phase 20's GPT-124M written in the Paddle surface
    (paddle_surface_gpt, phase 7's seeded weights carried in) built as a
    static program under enable_static() + program_guard: static.data ids
    and labels [8, 1024], F.cross_entropy, AdamW(1e-4, weight_decay 0.01,
    ClipGradByGlobalNorm(1.0)).minimize; 10 steps of Executor.run against
    10 of phase 20b's eager steps from the same weights: each loss within
    LOSS_RTOL, K1 = K2 = K3 = 12 a step, one graph for the feed
    signature; step ms, idle share, peak memory and the graph pool beside
    the eager steps'; then clone(for_test=True) leaves the weights as
    they are. Step 1's loss is 20b's; later steps are held to the eager
    steps with the position embedding frozen, as the reference's program
    leaves it (the distance to 20b's is printed). Returns the program's
    (K1, K2, K3) launches."""
    from paddle_tpu_torch.text import convert
    from paddle_tpu_torch.text.models import GPTForCausalLM
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv)
    cfg = TransformerLMConfig(tie_embeddings=False, dropout=0.0,
                              use_flash_attention=True)
    steps, b, s = DY2["program_steps"], 8, cfg.max_seq_len
    tg = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(1234))
    init_np = convert.state_dict_to_paddle_tpu(tg.state_dict())
    del tg
    ids_np = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, s)).astype(np.int64)

    def model_at_init():
        m = paddle_surface_gpt(paddle, cfg)
        check(m.set_state_dict(init_np) == [], "25c: weights missing")
        return m.train()

    def opt_for(m):
        return paddle.optimizer.AdamW(
            1e-4, parameters=m.parameters(), weight_decay=0.01,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))

    def measure(step):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers:
            w.launches = 0
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(step())
            times.append((time.perf_counter() - t0) * 1e3)
        return dict(losses=losses, times=times, held=held,
                    peak=torch.cuda.max_memory_allocated() - held,
                    launches=tuple(w.launches for w in wrappers))

    def eager_run(frozen):
        model, ids = model_at_init(), paddle.to_tensor(ids_np)
        if frozen:
            model.gpt.position_embeddings.weight.stop_gradient = True
        opt = opt_for(model)

        def eager_step():
            loss = model(ids, ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return float(loss.item())
        r = measure(eager_step)
        r["step_ms"] = float(np.median(r["times"][1:]))
        r["idle"] = None if frozen else static_idle(torch, eager_step, ())
        del model, opt, ids
        torch.cuda.empty_cache()
        return r
    # 20b's eager steps, and the same with the position embedding frozen:
    # the reference's program runs the position lookup (arange, then the
    # embedding, on no Variable) eagerly while it is built, so its
    # output is a constant and the embedding takes no grad from
    # Executor.run (ROADMAP's reference caveats)
    eager, frozen = eager_run(False), eager_run(True)

    model = model_at_init()
    paddle.enable_static()
    try:
        main = paddle.static.Program()
        with paddle.static.program_guard(main):
            i = paddle.static.data("ids", [b, s], "int64")
            lab = paddle.static.data("labels", [b, s], "int64")
            loss = model(i, lab)
            opt_for(model).minimize(loss)
        exe = paddle.static.Executor()
        feed = {"ids": ids_np, "labels": ids_np}

        def program_step():
            lv, = exe.run(main, feed=feed, fetch_list=[loss])
            return float(lv)
        prog = measure(program_step)
        prog["step_ms"] = float(np.median(prog["times"][3:]))
        fn, = exe._cache.values()
        graphs = fn.graphs()
        prog.update(capture_ms=graphs[0].capture_ms, pool=fn.pool_bytes(),
                    graphs=len(graphs),
                    replays=sum(g.replays for g in graphs))
        prog["idle"] = static_idle(torch, program_step, ())
        kinds = {}
        for rec in main.global_block().ops:
            kinds[rec.type] = kinds.get(rec.type, 0) + 1
        test = main.clone(for_test=True)
        w = model.gpt.blocks[0].attn.qkv.weight
        before = w.value.detach().clone()
        tl, = exe.run(test, feed=feed, fetch_list=[loss])
        torch.cuda.synchronize()
        unchanged = torch.equal(before, w.value)
    finally:
        paddle.disable_static()
    def distance(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]
    rel = distance(prog["losses"], frozen["losses"])
    rel20 = distance(prog["losses"], eager["losses"])
    print(f"    25c the program: {len(main.ops)} records "
          f"({kinds.get('flash_attention', 0)} flash_attention, "
          f"{kinds.get('linear', 0)} linear, {kinds.get('@grad', 0)} grad, "
          f"{kinds.get('@update', 0)} update); Executor.run losses "
          f"{[round(v, 6) for v in prog['losses']]}; eager, position "
          f"embedding frozen {[round(v, 6) for v in frozen['losses']]}: "
          f"largest distance {max(rel):.3e} relative; 20b's eager steps "
          f"{[round(v, 6) for v in eager['losses']]}: step 1 "
          f"{rel20[0]:.3e}, then up to {max(rel20):.3e} (step "
          f"{int(np.argmax(rel20)) + 1}; the position embedding trains "
          "there)")
    check(max(rel) <= LOSS_RTOL and rel20[0] <= LOSS_RTOL,
          f"25c: losses part from the eager steps' (frozen position "
          f"embedding) {rel}, 20b's step 1 {rel20[0]}")
    want = (steps * cfg.num_layers,) * 3
    check(prog["launches"] == want and eager["launches"] == want,
          f"25c: launches program {prog['launches']}, eager "
          f"{eager['launches']}, want {want}")
    check(prog["losses"][-1] < prog["losses"][0],
          f"25c: the program does not train: {prog['losses']}")
    check(prog["graphs"] == 1 and prog["replays"] == steps - 2,
          f"25c: {prog['graphs']} graphs, {prog['replays']} replays")
    check(unchanged and np.isfinite(tl),
          f"25c: clone(for_test=True) moved the weights ({unchanged}) or "
          f"gave {tl}")
    print(f"    25c clone(for_test=True): forward loss {float(tl):.6f}, the "
          "weights unchanged")
    static_report("25c surface GPT-124M f32 eager / Executor.run",
                  [(eager, False), (prog, True)], "tokens", b * s)
    return prog["launches"]


def dy2_birth(torch, paddle):
    """25d: with birth tracking on, a Tensor born in a captured branch and
    read after it raises TracerLeakError naming its op, file:line and
    scope; the card works on after."""
    from paddle_tpu_torch import analysis
    from paddle_tpu_torch.jit import to_static
    holder = {}

    def leaky(x):
        paddle.static.nn.cond(x.sum() > 0,
                              lambda: holder.__setitem__("t", x * 3.0),
                              lambda: None)
        return holder["t"] + 1.0

    traced = to_static(leaky)
    x = paddle.to_tensor(np.ones(256, np.float32))
    with analysis.birth_tracking():
        try:
            for _ in range(3):
                traced(x)
        except analysis.TracerLeakError as e:
            f, = e.findings
            torch.cuda.synchronize()
            ok = float((x + 1).sum().item())
            check(f["birth_op"] == "elementwise_mul"
                  and "chip_smoke.py:" in f["birth_site"]
                  and f["birth_trace"].startswith("cond_true#")
                  and ok == 512.0, f"25d: {f}; the card after: {ok}")
            print(f"    25d TracerLeakError: born in {f['birth_op']} at "
                  f"{os.path.basename(f['birth_site'])} under "
                  f"{f['birth_trace']}, read at "
                  f"{os.path.basename(f['escape_site'])}; eager work goes "
                  "on")
            return
    raise SmokeFailure("25d: a Tensor leaked out of a captured branch did "
                       "not raise")


def phase_dy2static(torch, attn, tce, amp, optimizer, TransformerLMConfig):
    """Phase 25: dy2static and the static graph on the card (25a-25d).
    Returns 25b's six launches and 25c's three."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as device_mod
    t0 = time.perf_counter()
    try:
        paddle.set_device("gpu")
        print("  [25a] dy2static's scenarios captured, against the CPU")
        dy2_cases_run(torch, paddle)
        print("  [25d] a Tensor leaked out of a captured branch")
        dy2_birth(torch, paddle)
        print("  [25b] the flagship with a Tensor `if` (a loss-spike guard)")
        flag = dy2_flagship(torch, attn, tce, amp, optimizer,
                            TransformerLMConfig, paddle)
        print("  [25c] the surface GPT-124M as a static program through "
              "Executor.run")
        prog = dy2_program(torch, attn, TransformerLMConfig, paddle)
    finally:
        device_mod._current_place = None
    print(f"  phase 25 in {time.perf_counter() - t0:.1f} s")
    return flag, prog


# --------------------------------------------------------------- phase 26

# phase 26: the Predictor's batches, runs a batch (run 1 eager, 2 recorded,
# 3 captured, then replays), PTQ's calibration batches, QAT's steps, the
# PredictorPool's threads
DEPLOY = dict(batches=(1, 4, 8), int8_batches=(1, 8), runs=6, calib=4,
              qat_steps=3, pool=4, pool_runs=4)
# 26a/26c/26e, a loaded program (the Predictor's CUDA graph) against the
# eager model on the card: the same kernels on the same operands, so the
# same bits are expected; where they part, within this share of the
# largest logit (f32 sums in another order)
DEPLOY_TOL = 1e-5
# 26a, the card's batch-1 logits against the CPU twin's (the same program
# on the CPU, plain attention): f32 sums in another order through 12
# layers (cuBLAS and K1 against the CPU's BLAS and the plain composition),
# held to phase 20a's card-against-CPU loss rule, LOSS_RTOL, as a share
# of the largest logit
# 26b, the W8A8 model against f32: the reference's own bar
# (tests/test_int8_inference.py:27-29)
INT8_REL_BAR = 0.1


def k1_inference_row(torch, attn, shape, fn=None, label="26"):
    """The f32 K1 at a Predictor's shape, causal: against its plain
    version (twice for the same bits), timed twice in turns with SDPA's
    f32 forward, the plain version, the bound. ``fn``: the entry that
    launches it (the wrapper, or the custom operator an exported program
    calls)."""
    fn = fn or attn.flash_attention_forward
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(26)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               for _ in range(3))
    scale = 1.0 / shape[-1] ** 0.5
    o, lse = fn(q, k, v, scale, True)
    again = fn(q, k, v, scale, True)
    ro, rlse = attn.flash_attention_plain(q, k, v, scale, True)
    torch.cuda.synchronize()
    err = max((o - ro).abs().max().item(), (lse - rlse).abs().max().item())
    check(err <= F32_FLASH_TOL and torch.equal(o, again[0])
          and torch.equal(lse, again[1]), f"{label}: K1 {list(shape)} causal f32:"
          f" err {err} (tol {F32_FLASH_TOL}) or two runs differ")
    times, libs = [], []
    for _ in range(2):
        times.append(time_ms(torch, lambda: fn(q, k, v, scale, True)))
        libs.append(time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True)))
    ms, lib_ms = float(np.median(times)), float(np.median(libs))
    plain_ms = time_ms(torch, lambda: attn.flash_attention_plain(
        q, k, v, scale, True), iters=10)
    b, h, s, d = shape
    flops = 4 * d * (b * h * s * (s + 1) // 2)
    b_ms, b_by = bound(4 * b * h * s * d * 4 + b * h * s * 4, flops,
                       "float32")
    print(f"    K1 {list(shape)} causal f32: max abs err {err:.3e} (tol "
          f"{F32_FLASH_TOL}), a second run the same bits; {ms:.4f} ms "
          f"({[round(t, 4) for t in times]}), {flops / ms / 1e9:.1f} "
          f"TFLOP/s, {b_ms / ms:.4f} of its bound {b_ms:.4f} ms ({b_by}); "
          f"SDPA f32 {lib_ms:.4f} ms ({[round(t, 4) for t in libs]}); plain "
          f"{plain_ms:.4f} ms")
    return {"name": "flash_attention_forward", "route": "cuda",
            "dtype": "float32", "shape": list(shape),
            "source": "paddle_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "paddle_tpu/ops/attention.py:67",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def same_or_close(a, b, tol, label):
    """Bits, or within ``tol`` of the largest |b|: returns the max abs
    difference and whether the bits are the same."""
    bits = np.array_equal(a, b)
    diff = 0.0 if bits else float(np.abs(a - b).max())
    scale = float(np.abs(b).max())
    check(bits or diff <= tol * scale, f"{label}: max abs diff {diff} > "
          f"{tol} of the largest {scale}")
    return diff, bits


def predictor_runs(torch, pred, ids, runs, attn):
    """``runs`` runs of ``pred`` on ``ids`` through its handles: each run's
    logits (copy_to_cpu), host-to-host ms and K1 launches."""
    k1 = attn.flash_attention_forward
    outs, times, launches = [], [], []
    name = pred.get_input_names()[0]
    for _ in range(runs):
        k1.launches = 0
        t0 = time.perf_counter()
        pred.get_input_handle(name).copy_from_cpu(ids)
        pred.run()
        out = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append(k1.launches)
        outs.append(out)
    return outs, times, launches


def device_ms(torch, fn, n=5):
    """Median device time of ``fn()`` between CUDA events."""
    out = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        out.append(s.elapsed_time(e))
    return float(np.median(out))


def gemm_device_ms(torch, fn):
    """Device ms of the GEMM kernels (cuBLAS's, whatever their dtype) in
    one profiled call of ``fn``, and of every kernel."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    gemm = total = 0.0
    names = set()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.end - e.time_range.start
        total += us
        low = e.name.lower()
        if "gemm" in low or "imma" in low or "i8" in low or "s8" in low:
            gemm += us
            names.add(e.name[:60])
    return gemm / 1e3, total / 1e3, sorted(names)[:3]


def phase_deploy(torch, attn, cfg):
    """Phase 26: phase 20's surface GPT-124M (phase 7's weights) saved
    with jit.save and served by inference.create_predictor on the card,
    in f32 (26a) and after PTQ + convert_to_int8 (26b); QAT steps and
    save_quantized_model (26c); onnx.export (26d); a changed position
    embedding in a saved .pdiparams (26e). Returns the K1 launches of
    the Predictor runs at batch 8 and at the other batches, the (K1, K2,
    K3) launches of the QAT steps, and the new K1 row."""
    import pickle
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference, onnx, quantization
    from paddle_tpu_torch.core import device as device_mod
    from paddle_tpu_torch.device import max_memory_allocated
    from paddle_tpu_torch.jit.save_load import load_program
    from paddle_tpu_torch.onnx_proto import onnx_pb2
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.text import convert
    from paddle_tpu_torch.text.models import GPTForCausalLM
    k1, k2, k3 = (attn.flash_attention_forward, attn.flash_bwd_dq,
                  attn.flash_bwd_dkv)
    L, S, V = cfg.num_layers, cfg.max_seq_len, cfg.vocab_size
    small, big = 0, 0            # K1 launches at batches 1/4 and at 8
    t_start = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    try:
        paddle.set_device("gpu")
        print("  [26] the new K1 row: the batch-1 Predictor's shape")
        row = k1_inference_row(torch, attn, (1, cfg.num_heads, S,
                                             cfg.hidden_size
                                             // cfg.num_heads))
        tg = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
            1234))
        init_np = convert.state_dict_to_paddle_tpu(tg.state_dict())
        del tg

        def model_at_init():
            m = paddle_surface_gpt(paddle, cfg)
            check(m.set_state_dict(init_np) == [], "26: weights missing")
            return m.eval()

        def ids_for(b, seed):
            return np.random.RandomState(seed).randint(0, V, (b, S)).astype(
                np.int64)

        def eager_logits(m, ids):
            with paddle.no_grad():
                return m(paddle.to_tensor(ids)).numpy()

        spec = [InputSpec([None, S], "int64")]
        print("  [26a] f32: jit.save, then create_predictor on the card")
        model = model_at_init()
        path = os.path.join(tmp.name, "gpt")
        t0 = time.perf_counter()
        paddle.jit.save(model, path, input_spec=spec)
        save_s = time.perf_counter() - t0
        sizes = {ext: os.path.getsize(path + ext)
                 for ext in (".pdmodel", ".pdiparams", ".pdmeta")}
        with open(path + ".pdmodel", "rb") as f:
            blob = pickle.load(f)
        with open(path + ".pdmeta", "rb") as f:
            meta = pickle.load(f)
        pnames = set(meta["program_names"].values())
        valued = [n for n in pnames if blob["persist"][n][0] is not None]
        kinds = {}
        for r in blob["records"]:
            kinds[r.get("type", r["kind"])] = kinds.get(
                r.get("type", r["kind"]), 0) + 1
        check(not valued and sizes[".pdmodel"] < (1 << 20),
              f"26a: .pdmodel {sizes['.pdmodel']} bytes, values kept for "
              f"{valued[:3]}")
        print(f"    saved in {save_s:.2f} s: .pdmodel {sizes['.pdmodel']} B "
              f"({len(blob['records'])} records: "
              f"{kinds.get('flash_attention', 0)} flash_attention, "
              f"{kinds.get('linear', 0)} linear, "
              f"{kinds.get('lookup_table_v2', 0)} lookup_table_v2; "
              f"{len(pnames)} parameters by name and shape, no values), "
              f".pdiparams {sizes['.pdiparams']} B, .pdmeta "
              f"{sizes['.pdmeta']} B")
        pred = inference.create_predictor(inference.Config(path + ".pdmodel"))
        check(pred.layer._device.type == "cuda", "26a: not on the card")
        want, f32 = {}, {}
        for b in DEPLOY["batches"]:
            ids = ids_for(b, 260 + b)
            want[b] = eager_logits(model, ids)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            outs, times, launches = predictor_runs(torch, pred, ids,
                                                   DEPLOY["runs"], attn)
            peak = max_memory_allocated()
            check(launches == [L] * DEPLOY["runs"],
                  f"26a: batch {b}: K1 launches a run {launches}, want {L}")
            if b == 8:
                big += sum(launches)
            else:
                small += sum(launches)
            diffs = [same_or_close(o, want[b], DEPLOY_TOL,
                                   f"26a batch {b} run {i + 1}")
                     for i, o in enumerate(outs)]
            check(all(np.array_equal(o, outs[2]) for o in outs[2:]),
                  f"26a batch {b}: the replays differ")
            x_dev = paddle.to_tensor(ids)
            dev = device_ms(torch, lambda: pred.layer(x_dev))
            f32[b] = dict(times=times, run_ms=float(np.median(times[3:])),
                          dev_ms=dev, peak=peak, held=held, logits=outs[-1])
            print(f"    batch {b}: run ms {[round(t, 2) for t in times]} "
                  f"(median of replays {f32[b]['run_ms']:.2f}, host to "
                  f"host, {b * S / f32[b]['run_ms'] * 1e3:.1f} scored "
                  f"tokens/s), device {dev:.3f} ms a replay "
                  f"({b * S / dev * 1e3:.1f} tokens/s); K1 {launches}; "
                  f"against the eager model: "
                  + ("the same bits every run" if all(d[1] for d in diffs)
                     else f"max abs diff {max(d[0] for d in diffs):.3e} "
                     f"(tol {DEPLOY_TOL} of the largest logit)")
                  + f"; peak {peak / 2**30:.3f} GiB, "
                  f"{(peak - held) / 2**30:.3f} over the {held / 2**30:.3f} "
                  "held before the runs")
        graphs = pred.layer.graphs()
        check(len(graphs) == len(DEPLOY["batches"]),
              f"26a: {len(graphs)} graphs for {len(DEPLOY['batches'])} "
              "batch sizes")
        pool_f32 = pred.layer.pool_bytes()
        ids8 = ids_for(8, 268)
        x8 = paddle.to_tensor(ids8)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        e_times = []
        for _ in range(4):
            t0 = time.perf_counter()
            eager_logits(model, ids8)
            e_times.append((time.perf_counter() - t0) * 1e3)
        e_peak = max_memory_allocated()
        with paddle.no_grad():
            e_dev = device_ms(torch, lambda: model(x8))
        e_ms = float(np.median(e_times[1:]))
        print(f"    batch 8 eager forward (no_grad, to_tensor to numpy): "
              f"{[round(t, 2) for t in e_times]} ms, median {e_ms:.2f} "
              f"({8 * S / e_ms * 1e3:.1f} tokens/s), device {e_dev:.3f} ms, "
              f"peak {e_peak / 2**30:.3f} GiB over {held / 2**30:.3f} held; "
              f"the Predictor's {len(graphs)} graphs' pool "
              f"{pool_f32 / 2**30:.3f} GiB, capture ms "
              f"{[round(g.capture_ms, 1) for g in graphs]}")

        # where the host-to-host time goes: the batch-8 logits (1.65 GB)
        # copied to pageable host memory, as copy_to_cpu does, against a
        # copy into a pinned buffer
        lv = pred.layer(x8).value
        pinned = torch.empty(lv.shape, dtype=lv.dtype, pin_memory=True)
        copies = {"pageable": [], "pinned": []}
        for _ in range(3):
            for kind in copies:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if kind == "pinned":
                    pinned.copy_(lv)
                else:
                    lv.cpu()
                torch.cuda.synchronize()
                copies[kind].append((time.perf_counter() - t0) * 1e3)
        print(f"    the batch-8 logits ({lv.numel() * 4 / 1e9:.2f} GB) to the "
              f"host: pageable {[round(t, 1) for t in copies['pageable']]} "
              f"ms, into a pinned buffer "
              f"{[round(t, 1) for t in copies['pinned']]} ms")
        del lv, pinned
        cpu = paddle.jit.load(path, device="cpu")
        t0 = time.perf_counter()
        cpu_out = cpu(paddle.to_tensor(ids_for(1, 261),
                                       place=paddle.CPUPlace())).numpy()
        cpu_s = time.perf_counter() - t0
        err = float(np.abs(f32[1]["logits"] - cpu_out).max())
        scale = float(np.abs(cpu_out).max())
        check(err <= LOSS_RTOL * scale, f"26a: batch 1 card vs CPU twin: "
              f"{err} > {LOSS_RTOL} of {scale}")
        print(f"    batch 1 against the CPU twin (the same files, "
              f"jit.load(device='cpu'), {cpu_s:.1f} s): max abs diff "
              f"{err:.3e}, {err / scale:.3e} of the largest logit (tol "
              f"{LOSS_RTOL})")
        del cpu, cpu_out

        loaded = paddle.jit.load(path)
        k1.launches = 0
        lo = [loaded(paddle.to_tensor(ids_for(4, 264))).numpy()
              for _ in range(4)]
        small += k1.launches
        check(all(np.array_equal(o, f32[4]["logits"]) for o in lo),
              "26a: jit.load's batch-4 logits are not the Predictor's")
        print("    jit.load: batch 4 over 4 calls = the Predictor's logits, "
              "bit for bit")
        del loaded, lo

        pool = inference.PredictorPool(inference.Config(path + ".pdmodel"),
                                       size=DEPLOY["pool"])
        pool_ids = [ids_for(1, 270 + i) for i in range(DEPLOY["pool"])]
        pool_want = [eager_logits(model, x) for x in pool_ids]
        got, errs = [None] * DEPLOY["pool"], []
        k1.launches = 0

        def serve(i):
            try:
                p = pool.retrieve(i)
                name = p.get_input_names()[0]
                for _ in range(DEPLOY["pool_runs"]):
                    p.get_input_handle(name).copy_from_cpu(pool_ids[i])
                    p.run()
                    got[i] = p.get_output_handle("out0").copy_to_cpu()
            except Exception as e:  # noqa: BLE001 - reported below
                errs.append((i, repr(e)))
        threads = [threading.Thread(target=serve, args=(i,))
                   for i in range(DEPLOY["pool"])]
        [t.start() for t in threads]
        [t.join() for t in threads]
        small += k1.launches
        check(not errs, f"26a: PredictorPool threads: {errs}")
        shared = {id(pool.retrieve(i).layer.state_dict()["gpt.ln_f.weight"])
                  for i in range(DEPLOY["pool"])}
        check(len(shared) == 1, "26a: the pool's predictors hold "
              f"{len(shared)} copies of the parameters")
        pool_diffs = [same_or_close(g, w, DEPLOY_TOL, f"26a pool {i}")
                      for i, (g, w) in enumerate(zip(got, pool_want))]
        check(k1.launches == DEPLOY["pool"] * DEPLOY["pool_runs"] * L,
              f"26a: the pool's K1 launches {k1.launches}")
        print(f"    PredictorPool({DEPLOY['pool']}) from {DEPLOY['pool']} "
              f"threads, {DEPLOY['pool_runs']} runs each on its own batch: "
              + ("every thread its own batch's logits, the same bits"
                 if all(d[1] for d in pool_diffs) else
                 f"max abs diff {max(d[0] for d in pool_diffs):.3e}")
              + f"; K1 {k1.launches}; one copy of the parameters")
        del pool, pred
        torch.cuda.empty_cache()

        print("  [26b] int8: PTQ abs_max over 4 batches, convert_to_int8, "
              "jit.save, create_predictor")
        qm = model_at_init()
        ptq = quantization.PostTrainingQuantization(qm, algo="abs_max")
        t0 = time.perf_counter()
        with paddle.no_grad():
            for i in range(DEPLOY["calib"]):
                ptq.sample(paddle.to_tensor(ids_for(8, 280 + i)))
        ptq.convert()
        quantization.convert_to_int8(qm)
        calib_s = time.perf_counter() - t0
        lins = [m for m in qm.sublayers()
                if isinstance(m, quantization.Int8Linear)]
        check(len(lins) == 4 * L + 1 and all(
            m.w_q.value.dtype == torch.int8 and m.w_q.value.is_cuda
            for m in lins), f"26b: {len(lins)} Int8Linear")
        qpath = os.path.join(tmp.name, "gpt_int8")
        paddle.jit.save(qm, qpath, input_spec=spec)
        qsize = os.path.getsize(qpath + ".pdiparams")
        qpred = inference.create_predictor(inference.Config(
            qpath + ".pdmodel"))
        calls = [0]
        real_int_mm = torch._int_mm

        def counted(a, b_):
            calls[0] += 1
            return real_int_mm(a, b_)
        int8 = {}
        for b in DEPLOY["int8_batches"]:
            ids = ids_for(b, 260 + b)
            qwant = eager_logits(qm, ids)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            torch._int_mm = counted
            try:
                outs, times, launches = predictor_runs(torch, qpred, ids,
                                                       DEPLOY["runs"], attn)
            finally:
                torch._int_mm = real_int_mm
            peak = max_memory_allocated()
            check(launches == [L] * DEPLOY["runs"],
                  f"26b: batch {b}: K1 launches a run {launches}")
            if b == 8:
                big += sum(launches)
            else:
                small += sum(launches)
            check(calls[0] == 3 * len(lins), f"26b: batch {b}: "
                  f"torch._int_mm called {calls[0]} times in the eager, "
                  f"record and capture runs, want {3 * len(lins)}")
            calls[0] = 0
            diffs = [same_or_close(o, qwant, DEPLOY_TOL, f"26b batch {b}")
                     for o in outs]
            ref32 = want[b]
            rel = float(np.abs(ref32 - outs[-1]).max() / np.abs(ref32).max())
            top1 = float((ref32.argmax(-1) == outs[-1].argmax(-1)).mean())
            check(rel < INT8_REL_BAR, f"26b: batch {b}: max|f32 - int8| / "
                  f"max|f32| = {rel} (bar {INT8_REL_BAR})")
            x_dev = paddle.to_tensor(ids)
            dev = device_ms(torch, lambda: qpred.layer(x_dev))
            int8[b] = dict(run_ms=float(np.median(times[3:])), dev_ms=dev,
                           peak=peak)
            print(f"    batch {b}: run ms {[round(t, 2) for t in times]} "
                  f"(median of replays {int8[b]['run_ms']:.2f}, "
                  f"{b * S / int8[b]['run_ms'] * 1e3:.1f} tokens/s; f32 "
                  f"{f32[b]['run_ms']:.2f}), device {dev:.3f} ms "
                  f"({b * S / dev * 1e3:.1f} tokens/s; f32 "
                  f"{f32[b]['dev_ms']:.3f}); K1 {launches}; torch._int_mm "
                  f"{len(lins)} a run; against f32: max|diff|/max|f32| "
                  f"{rel:.4f} (bar {INT8_REL_BAR}), top-1 agreement {top1:.4f}; "
                  f"against the int8 model eager: "
                  + ("the same bits" if all(d[1] for d in diffs) else
                     f"max abs diff {max(d[0] for d in diffs):.3e}")
                  + f"; peak {peak / 2**30:.3f} GiB, "
                  f"{(peak - held) / 2**30:.3f} over {held / 2**30:.3f} held "
                  f"(f32 {(f32[b]['peak'] - f32[b]['held']) / 2**30:.3f} over "
                  f"{f32[b]['held'] / 2**30:.3f})")
        with paddle.no_grad():
            g32, all32, n32 = gemm_device_ms(torch, lambda: model(x8))
            g8, all8, n8 = gemm_device_ms(torch, lambda: qm(x8))
        print(f"    PTQ + convert in {calib_s:.1f} s; {len(lins)} Int8Linear, "
              f"w_q int8 on the card; .pdiparams {qsize} B against f32's "
              f"{sizes['.pdiparams']} B; the graph pool "
              f"{qpred.layer.pool_bytes() / 2**30:.3f} GiB; one profiled "
              f"eager forward at batch 8: GEMMs {g8:.3f} ms of {all8:.3f} "
              f"(int8, {n8}) against {g32:.3f} of {all32:.3f} (f32 cuBLAS, "
              f"TF32 off, {n32})")
        del qpred, qm, ptq
        torch.cuda.empty_cache()

        print(f"  [26c] QAT: ImperativeQuantAware, {DEPLOY['qat_steps']} "
              "AdamW steps at 8 x 1024, save_quantized_model, Predictor")
        qat = paddle_surface_gpt(paddle, cfg)
        check(qat.set_state_dict(init_np) == [], "26c: weights missing")
        quantization.ImperativeQuantAware().quantize(qat)
        qat.train()
        opt = paddle.optimizer.AdamW(
            1e-4, parameters=qat.parameters(), weight_decay=0.01,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
        ids = paddle.to_tensor(ids_for(8, 290))
        losses, steps_ms, qat_counts = [], [], []
        for _ in range(DEPLOY["qat_steps"]):
            for w in (k1, k2, k3):
                w.launches = 0
            t0 = time.perf_counter()
            loss = qat(ids, ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.item()))
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            qat_counts.append((k1.launches, k2.launches, k3.launches))
        check(all(np.isfinite(losses)) and all(c == (L, L, L)
                                               for c in qat_counts),
              f"26c: losses {losses}, launches {qat_counts}")
        qat_total = tuple(sum(c[i] for c in qat_counts) for i in range(3))
        del opt, loss
        qpath = os.path.join(tmp.name, "gpt_qat")
        quantization.ImperativeQuantAware().save_quantized_model(
            qat, qpath, input_spec=spec)
        qpred = inference.create_predictor(inference.Config(
            qpath + ".pdmodel"))
        ids1 = ids_for(1, 261)
        qwant = eager_logits(qat, ids1)
        outs, _, launches = predictor_runs(torch, qpred, ids1, 4, attn)
        small += sum(launches)
        diffs = [same_or_close(o, qwant, DEPLOY_TOL, "26c") for o in outs]
        print(f"    losses {[round(v, 6) for v in losses]}, step ms "
              f"{[round(t, 1) for t in steps_ms]}, K1/K2/K3 a step "
              f"{qat_counts[0]}; the saved QAT model's Predictor at batch 1 "
              f"over 4 runs: "
              + ("the eval forward's bits" if all(d[1] for d in diffs) else
                 f"max abs diff {max(d[0] for d in diffs):.3e}")
              + f"; K1 {launches}")
        del qpred, qat
        torch.cuda.empty_cache()

        print("  [26d] onnx.export of the f32 model at [1, 1024] from the "
              "card")
        t0 = time.perf_counter()
        opath = onnx.export(model, os.path.join(tmp.name, "gpt"),
                            input_spec=[InputSpec([1, S], "int64")])
        ex_s = time.perf_counter() - t0
        mp = onnx_pb2.ModelProto()
        with open(opath, "rb") as f:
            mp.ParseFromString(f.read())
        inits = {t.name: t for t in mp.graph.initializer}
        sd = model.state_dict()
        matched = 0
        for n, p in sd.items():
            if n in inits:
                arr = np.frombuffer(inits[n].raw_data, np.float32).reshape(
                    list(inits[n].dims))
                check(np.array_equal(arr, p.numpy()),
                      f"26d: initializer {n} is not the card's weight")
                matched += 1
        nodes = {}
        for n in mp.graph.node:
            nodes[n.op_type] = nodes.get(n.op_type, 0) + 1
        check(matched == len(sd) - 1 and mp.ir_version == 8
              and nodes.get("Softmax") == L,
              f"26d: {matched} of {len(sd)} weights as initializers, "
              f"nodes {nodes}")
        print(f"    exported in {ex_s:.1f} s, {os.path.getsize(opath)} B, "
              f"re-parsed: ir_version {mp.ir_version}, opset "
              f"{mp.opset_import[0].version}, {len(mp.graph.node)} nodes "
              f"{dict(sorted(nodes.items()))}; {matched} of {len(sd)} "
              "weights as initializers under their structured names, the "
              "card's bits (the position embedding folded into its lookup)")
        del mp, inits

        print("  [26e] a changed position embedding in a saved .pdiparams")
        sd_np = paddle.load(path + ".pdiparams")
        key = "gpt.position_embeddings.weight"
        new = sd_np[key] + np.random.RandomState(26).randn(
            *sd_np[key].shape).astype(np.float32) * 0.05
        sd_np[key] = new
        paddle.save(sd_np, path + ".pdiparams")
        changed = paddle.jit.load(path)
        k1.launches = 0
        got = changed(paddle.to_tensor(ids1)).numpy()
        small += k1.launches
        old = want[1]
        model.gpt.position_embeddings.weight.set_value(new)
        ew = eager_logits(model, ids1)
        d, bits = same_or_close(got, ew, DEPLOY_TOL, "26e")
        moved = float(np.abs(ew - old).max())
        check(moved > 1e-3, f"26e: the change moved the logits by {moved}")
        print(f"    jit.load gives the changed model's logits "
              + ("bit for bit" if bits else f"within {d:.3e}")
              + f" (they moved by up to {moved:.3e} from the saved model's)")
        del changed, model
        torch.cuda.empty_cache()
    finally:
        device_mod._current_place = None
        tmp.cleanup()
    print(f"  phase 26 in {time.perf_counter() - t_start:.1f} s")
    return big, small, qat_total, row


# --------------------------------------------------------------- phase 27

LAZY = dict(steps=10, bert_steps=8, edge_steps=6)


def memory_report(torch, label):
    """Collect garbage, return the card's free segments, and print what
    the caching allocator still holds: allocated and reserved GiB, the
    CUDA graphs alive, and the reserved segments of the default pool and
    of the CUDA graphs' private pools with the GiB in use in them (a
    segment that stays reserved holds at least one live block).
    tools/phase_memory.py prints the same lines for another checkout's
    phases."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    graphs = sum(1 for o in gc.get_objects()
                 if isinstance(o, torch.cuda.CUDAGraph))
    pools = {}
    for seg in torch.cuda.memory_snapshot():
        pid = tuple(seg.get("segment_pool_id", (0, 0)))
        n, size, used = pools.get(pid, (0, 0, 0))
        pools[pid] = (n + 1, size + seg["total_size"],
                      used + seg["allocated_size"])
    gib = 2 ** 30
    dn, dsize, dused = pools.pop((0, 0), (0, 0, 0))
    gn, gsize, gused = (sum(v[i] for v in pools.values()) for i in range(3))
    print(f"    {label}: {torch.cuda.memory_allocated() / gib:.3f} GiB "
          f"allocated, {torch.cuda.memory_reserved() / gib:.3f} reserved; "
          f"{graphs} CUDA graphs alive; default pool {dn} segments "
          f"{dsize / gib:.3f} GiB ({dused / gib:.3f} in use); "
          f"{len(pools)} graph pools {gn} segments {gsize / gib:.3f} GiB "
          f"({gused / gib:.3f} in use)")


def lazy_release(torch, label=None):
    """Drop the lazy executor's replay cache and this thread's graph pool,
    and return the card's free memory (between the phases that train
    through it); with ``label``, print what the card still holds."""
    import gc
    from paddle_tpu_torch.core import lazy
    lazy.flush()
    lazy.clear()
    gc.collect()
    torch.cuda.empty_cache()
    if label is not None:
        memory_report(torch, label)


def paddle_surface_bert(paddle, cfg):
    """BERT-base pretraining as a user writes it in the port's Paddle
    surface, the structure and names of the reference's
    paddle_tpu/text/models.py:224-286 and :812-851 (the _TransformerCore
    post-norm blocks with token types, the pooler, the MLM transform and
    LayerNorm with the word embedding as the MLM head, the NSP head):
    nn.Layer, nn.Embedding, nn.LayerList, nn.LayerNorm, nn.Linear, a
    fused QKV split by paddle.reshape/transpose/unbind into
    nn.functional.scaled_dot_product_attention (non-causal), gelu
    (approximate=True), paddle.matmul(transpose_y=True) and
    nn.functional.cross_entropy(ignore_index=-1). Dropout 0."""
    nn, F = paddle.nn, paddle.nn.functional
    h, heads = cfg.hidden_size, cfg.num_heads

    class SelfAttention(nn.Layer):
        def __init__(self):
            super().__init__()
            self.qkv = nn.Linear(h, 3 * h)
            self.out = nn.Linear(h, h)

        def forward(self, x):
            b, s, _ = x.shape
            qkv = paddle.reshape(self.qkv(x), [b, s, 3, heads, h // heads])
            q, k, v = paddle.unbind(paddle.transpose(qkv, [2, 0, 3, 1, 4]),
                                    axis=0)
            o = F.scaled_dot_product_attention(q, k, v, is_causal=False)
            return self.out(paddle.reshape(
                paddle.transpose(o, [0, 2, 1, 3]), [b, s, h]))

    class MLP(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = nn.Linear(h, cfg.intermediate_size)
            self.fc2 = nn.Linear(cfg.intermediate_size, h)

        def forward(self, x):
            return self.fc2(F.gelu(self.fc1(x), approximate=True))

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(h)
            self.attn = SelfAttention()
            self.ln2 = nn.LayerNorm(h)
            self.mlp = MLP()

        def forward(self, x):
            x = self.ln1(paddle.add(x, self.attn(x)))
            return self.ln2(paddle.add(x, self.mlp(x)))

    class BertModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
            self.position_embeddings = nn.Embedding(cfg.max_seq_len, h)
            self.token_type_embeddings = nn.Embedding(2, h)
            self.blocks = nn.LayerList([Block()
                                        for _ in range(cfg.num_layers)])
            self.ln_f = nn.LayerNorm(h)
            self.pooler = nn.Linear(h, h)

        def forward(self, ids, tok):
            pos = paddle.arange(0, ids.shape[1], dtype="int64")
            x = paddle.add(self.word_embeddings(ids),
                           self.position_embeddings(pos))
            x = paddle.add(x, self.token_type_embeddings(tok))
            for blk in self.blocks:
                x = blk(x)
            return x, paddle.tanh(self.pooler(x[:, 0]))

    class BertForPretraining(nn.Layer):
        def __init__(self):
            super().__init__()
            self.bert = BertModel()
            self.mlm_transform = nn.Linear(h, h)
            self.mlm_ln = nn.LayerNorm(h)
            self.nsp_head = nn.Linear(h, 2)

        def forward(self, ids, tok, mlm, nsp):
            x, pooled = self.bert(ids, tok)
            t = self.mlm_ln(F.gelu(self.mlm_transform(x), approximate=True))
            logits = paddle.matmul(t, self.bert.word_embeddings.weight,
                                   transpose_y=True)
            mlm_loss = F.cross_entropy(
                paddle.reshape(logits, [-1, cfg.vocab_size]),
                paddle.reshape(mlm, [-1]), ignore_index=-1)
            nsp_loss = F.cross_entropy(self.nsp_head(pooled),
                                       paddle.reshape(nsp, [-1]))
            return paddle.add(mlm_loss, nsp_loss)

    return BertForPretraining()


def lazy_train(torch, paddle, build, steps, flag, wrappers, profile=False,
               idle=True):
    """From a released cache, ``steps`` plain eager steps
    (``loss.backward(); opt.step(); opt.clear_grad()``, then
    ``float(loss)``) of ``build()`` -> (model, opt, args, amp_ctx) with
    FLAGS_lazy_eager ``flag``: the losses,
    each step's ms, flush forms and launches, the peak memory over what
    was held before, the graph pool's bytes, the weights after, and the
    idle share over 3 more profiled steps."""
    from paddle_tpu_torch.core import lazy
    lazy_release(torch)
    paddle.set_flags({"FLAGS_lazy_eager": flag})
    try:
        model, opt, args, ctx = build()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = dict(losses=[], times=[], forms=[], launches=[])

        def step():
            with ctx():
                loss = model(*args)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return float(loss)

        for _ in range(steps):
            for w in wrappers:
                w.launches = 0
            seen = lazy.flushes[0]
            t0 = time.perf_counter()
            res["losses"].append(step())
            torch.cuda.synchronize()
            res["times"].append((time.perf_counter() - t0) * 1e3)
            res["forms"].append(lazy.forms_since(seen))
            res["launches"].append(tuple(w.launches for w in wrappers))
        res["peak"] = torch.cuda.max_memory_allocated() - held
        res["held"] = held
        res["pool"] = lazy.pool_bytes()
        res["entries"] = len(lazy._replay_cache)
        res["weights"] = {n: p.value.detach().clone()
                          for n, p in model.named_parameters()}
        res["idle"] = static_idle(torch, step, ()) if idle else None
        if profile:
            res["model"], res["opt"], res["step"] = model, opt, step
        res["step_ms"] = float(np.median(res["times"][3:] if flag
                                         else res["times"][1:]))
        return res
    finally:
        paddle.set_flags({"FLAGS_lazy_eager": True})


def lazy_first_difference(torch, paddle, build):
    """Step 1's forward lazily and immediately with every sublayer's
    output read as it is made: the first sublayer whose output differs
    and by how much (the diagnosis of a lazy run that left immediate's
    bits)."""
    outs = {}
    for flag in (True, False):
        paddle.set_flags({"FLAGS_lazy_eager": flag})
        model, _, args, ctx = build()
        seen = outs[flag] = []
        for name, layer in model.named_sublayers():
            layer.register_forward_post_hook(
                lambda lay, inp, out, name=name: seen.append(
                    (name, out.value.detach().clone()
                     if hasattr(out, "value") else None)))
        with ctx():
            model(*args)
    paddle.set_flags({"FLAGS_lazy_eager": True})
    for (name, a), (_, b) in zip(outs[True], outs[False]):
        if a is not None and not torch.equal(a, b):
            return name, (a.float() - b.float()).abs().max().item()
    return None, 0.0


def lazy_gpt(torch, attn, cfg):
    """27a: phase 20's surface GPT-124M (phase 7's weights, untied f32,
    8 x 1024, AdamW + ClipGradByGlobalNorm(1.0)) as a plain eager loop,
    10 steps lazily against 10 immediately, in turns (lazy, immediate,
    immediate, lazy): losses and weights bit for bit, K1 = K2 = K3 = 12 a
    step, one replay-cache entry, a graph replay every step from step 3;
    median step ms, idle share, peak memory and the graph pool. Returns
    the lazy runs' (K1, K2, K3) and the last lazy run (its model kept,
    for 27e's profile)."""
    import contextlib as cl
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.text import convert
    from paddle_tpu_torch.text.models import GPTForCausalLM
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv)
    L, steps = cfg.num_layers, LAZY["steps"]
    init_np = convert.state_dict_to_paddle_tpu(GPTForCausalLM(
        cfg, generator=torch.Generator().manual_seed(1234),
        device="cpu").state_dict())
    ids_np = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, cfg.max_seq_len)).astype(np.int64)

    def build():
        model = paddle_surface_gpt(paddle, cfg)
        check(model.set_state_dict(init_np) == [], "27a: weights missing")
        model.train()
        opt = paddle.optimizer.AdamW(
            1e-4, parameters=model.parameters(), weight_decay=0.01,
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
        ids = paddle.to_tensor(ids_np)
        return model, opt, (ids, ids), cl.nullcontext

    runs = [lazy_train(torch, paddle, build, steps, flag, wrappers,
                       profile=k == 3)
            for k, flag in enumerate((True, False, False, True))]
    lz, im = runs[0], runs[1]
    same_losses = all(r["losses"] == lz["losses"] for r in runs[1:])
    apart = [n for n in im["weights"]
             if not torch.equal(lz["weights"][n], im["weights"][n])]
    if not same_losses or apart:
        name, diff = lazy_first_difference(torch, paddle, build)
        print(f"    27a: the lazy run parts from immediate's: first at "
              f"sublayer {name!r}, max abs diff {diff:.3e}; weights apart "
              f"{apart[:4]}")
    check(same_losses, f"27a: losses lazy {lz['losses']} vs immediate "
          f"{im['losses']}")
    check(not apart, f"27a: weights apart from immediate's: {apart[:4]}")
    for r in (runs[0], runs[3]):
        check(all(c == (L, L, L) for c in r["launches"]),
              f"27a: K1/K2/K3 a step {r['launches']}, want {(L, L, L)}")
        check(all(len(f) == 1 for f in r["forms"])
              and [f[0] for f in r["forms"][:3]]
              == ["warmup", "record", "capture"]
              and all(f == ["replay"] for f in r["forms"][3:]),
              f"27a: flush forms a step {r['forms']}")
        check(r["entries"] == 1, f"27a: {r['entries']} replay-cache "
              "entries in steady state, want 1")
    print(f"    losses {[round(v, 6) for v in lz['losses']]}: every run's "
          f"bits the same (lazy, immediate, immediate, lazy), and every "
          f"weight after 10 steps; flush forms a step "
          f"{[f[0] for f in lz['forms']]}; K1/K2/K3 a step "
          f"{lz['launches'][0]} (captured x replays from step 3); replay-"
          f"cache entries {lz['entries']}")
    for label, r in (("lazy", runs[3]), ("immediate", runs[2])):
        idle = "not measured" if r["idle"] is None else f"{r['idle']:.4f}"
        print(f"    {label:9s}: median step {r['step_ms']:.3f} ms "
              f"({ids_np.size / r['step_ms'] * 1e3:.1f} tokens/s), idle "
              f"share {idle}, peak {r['peak'] / 2**30:.3f} GiB over "
              f"{r['held'] / 2**30:.3f} held, graph pool "
              f"{r['pool'] / 2**30:.3f} GiB; step ms "
              f"{[round(t, 2) for t in r['times']]}")
    total = tuple(sum(sum(c[i] for c in r["launches"])
                      for r in (runs[0], runs[3])) for i in range(3))
    return total, runs[3]


def lazy_lenet(torch, paddle):
    """27b: config 1 (LeNet, Adam 1e-3, batch 64, 24e's step) lazily,
    immediately and through to_static, under deterministic algorithms:
    losses bit for bit; step ms and idle share each."""
    from paddle_tpu_torch.vision import models
    b = LENET["batch"]

    def build():
        paddle.seed(0)
        net = models.LeNet()
        opt = paddle.optimizer.Adam(1e-3, parameters=net.parameters())
        loss_fn = paddle.nn.CrossEntropyLoss()
        rs = np.random.RandomState(1)
        x = paddle.to_tensor(rs.randn(b, 1, 28, 28).astype("float32"))
        y = paddle.to_tensor(rs.randint(0, 10, (b,)).astype("int64"))

        def step():
            loss = loss_fn(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss
        return step, (), net

    with static_deterministic(torch, "27b LeNet config 1"):
        runs = [(static_run(torch, build, STATIC["lenet_calls"], cap,
                            lazy=lz), cap, lz)
                for cap, lz in ((False, True), (False, False), (True, False))]
    static_same("27b LeNet config 1 (lazy, immediate, to_static) under "
                "deterministic algorithms", [(r, c) for r, c, _ in runs])
    forms = runs[0][0]["forms"]
    check(all(f == ["replay"] for f in forms[3:]),
          f"27b: lazy flush forms {forms}")
    for (r, cap, lz), label in zip(runs, ("lazy", "immediate",
                                          "to_static")):
        idle = "not measured" if r["idle"] is None else f"{r['idle']:.4f}"
        print(f"    27b {label:9s}: step {r['step_ms']:.3f} ms "
              f"({b / r['step_ms'] * 1e3:.1f} samples/s), idle share "
              f"{idle}, peak {r['peak'] / 2**30:.3f} GiB")


def lazy_bert(torch, attn, amp):
    """27c: config 3 (BERT-base, bench_bert's 32 x 128, O1 bf16, AdamW)
    written in the Paddle surface (paddle_surface_bert) with the torch
    bert_base's weights through text.convert: its f32 loss at those
    weights within LOSS_RTOL of the torch model's; 8 steps lazily and
    immediately, first under deterministic algorithms (bit for bit), then
    under the default ones (lazy, immediate, immediate): K1-K3 = 12 a
    step (the bf16 non-causal [32,12,128,64]), losses within STATIC_TOL
    of immediate's or one quantum of the O1 loss apart (one bf16 step of
    its MLM sum); step ms and idle share. Returns the default lazy run's
    (K1, K2, K3)."""
    import contextlib as cl
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.text import convert
    from paddle_tpu_torch.text.models import bert_base
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv)
    tb = bert_base(max_seq_len=BERT["seq"], dropout=0.0,
                   generator=torch.Generator().manual_seed(0)).train()
    cfg = tb.cfg
    init_np = convert.state_dict_to_paddle_tpu(tb.state_dict())
    data = bert_data(BERT["batch"], BERT["seq"], cfg.vocab_size)
    with torch.no_grad():
        want = tb(*(torch.from_numpy(a).cuda() for a in data)).item()
    del tb
    torch.cuda.empty_cache()

    def build(ctx=True):
        model = paddle_surface_bert(paddle, cfg)
        check(model.set_state_dict(init_np) == [], "27c: weights missing")
        model.train()
        opt = paddle.optimizer.AdamW(1e-4, parameters=model.parameters(),
                                     weight_decay=0.01)
        args = tuple(paddle.to_tensor(a) for a in data)
        amp_ctx = (lambda: amp.auto_cast(level="O1", dtype="bfloat16")) \
            if ctx else cl.nullcontext
        return model, opt, args, amp_ctx

    model, _, args, _ = build(ctx=False)
    with paddle.no_grad():
        got = float(model(*args))
    del model, args
    rel = abs(got - want) / abs(want)
    check(rel <= LOSS_RTOL, f"27c: the surface BERT's f32 loss {got} vs "
          f"the torch bert_base's {want}")
    print(f"    the surface BERT-base at the torch bert_base's weights: f32 "
          f"loss {got:.6f} against {want:.6f} (rel {rel:.2e}, tol "
          f"{LOSS_RTOL})")
    steps, L = LAZY["bert_steps"], cfg.num_layers
    with static_deterministic(torch, "27c BERT-base O1"):
        det = [lazy_train(torch, paddle, build, steps, flag, wrappers,
                          idle=False) for flag in (True, False)]
    lazy_release(torch)
    check(det[0]["losses"] == det[1]["losses"], f"27c: under deterministic "
          f"algorithms lazy {det[0]['losses']} vs {det[1]['losses']}")
    runs = [lazy_train(torch, paddle, build, steps, flag, wrappers)
            for flag in (True, False, False)]
    lazy_release(torch)
    lz, im, im2 = runs
    check(all(c == (L, L, L) for c in lz["launches"]),
          f"27c: K1/K2/K3 a step {lz['launches']}")
    check(all(f == ["replay"] for f in lz["forms"][3:]),
          f"27c: flush forms {lz['forms']}")
    check(lz["losses"][-1] < lz["losses"][0], f"27c: loss did not fall "
          f"{lz['losses']}")
    # the MLM loss is a bf16 sum over the batch's masked tokens divided by
    # their count (cross_entropy op for op as the reference's, under O1):
    # its resolution is one bf16 step of that sum over the count, which a
    # run whose bits part at all (eager BERT does: its embedding grads)
    # may cross
    n_mlm = int((data[2] != -1).sum())

    def quantum(loss):
        return 2.0 ** (np.floor(np.log2(loss * n_mlm)) - 7) / n_mlm

    def parts(a, b):
        rel = [abs(x - y) / abs(y) for x, y in zip(a, b)]
        steps_apart = [i for i, (x, y) in enumerate(zip(a, b))
                       if abs(x - y) / abs(y) > STATIC_TOL["bert"]]
        return max(rel), steps_apart, all(
            abs(a[i] - b[i]) <= 1.01 * quantum(b[i]) for i in steps_apart)

    worst, apart, one_step = parts(lz["losses"], im["losses"])
    worst_im, apart_im, _ = parts(im2["losses"], im["losses"])
    check(one_step, f"27c: lazy losses {lz['losses']} vs immediate "
          f"{im['losses']}: steps {apart} past STATIC_TOL by more than the "
          "loss's resolution")
    print(f"    {steps} steps each under deterministic algorithms: lazy = "
          f"immediate bit for bit, losses "
          f"{[round(v, 6) for v in det[0]['losses']]}")
    print(f"    default algorithms: losses lazy "
          f"{[round(v, 6) for v in lz['losses']]}, within {worst:.3e} of "
          f"immediate's (tol {STATIC_TOL['bert']}"
          + (f"; steps {apart} one quantum apart, "
             f"{quantum(im['losses'][apart[0]]):.4f}: one bf16 step of the "
             f"MLM sum over its {n_mlm} tokens" if apart else "")
          + f"); a second immediate run {worst_im:.3e} from the first"
          + (f" (steps {apart_im})" if apart_im else "")
          + f"; flush forms {[f[0] for f in lz['forms']]}; K1/K2/K3 a step "
          f"{lz['launches'][0]}")
    for label, r in (("lazy", lz), ("immediate", im), ("immediate", im2)):
        idle = "not measured" if r["idle"] is None else f"{r['idle']:.4f}"
        print(f"    {label:9s}: median step {r['step_ms']:.3f} ms "
              f"({BERT['batch'] / r['step_ms'] * 1e3:.1f} samples/s), idle "
              f"share {idle}, peak {r['peak'] / 2**30:.3f} GiB, graph pool "
              f"{r['pool'] / 2**30:.3f} GiB")
    return tuple(sum(c[i] for c in lz["launches"]) for i in range(3))


def lazy_edges(torch, paddle):
    """27d: edge cases on the card, each leaving it working: a float(loss)
    before backward() (two segments, the forward's node by node, counted);
    the GradScaler's skipped inf step; dropout's masks new on every replay
    and the immediate masks for the same seed; masked_select after a
    pending graph; a write through a view; a set_value between steps; a
    StepDecay stepped between replays; paddle.grad(create_graph=True)."""
    from paddle_tpu_torch.core import lazy
    nn, F = paddle.nn, paddle.nn.functional
    n = LAZY["edge_steps"]
    rs = np.random.RandomState(27)
    x_np = rs.randn(64, 256).astype("float32")
    state = None

    def mlp():
        nonlocal state
        net = nn.Sequential(nn.Linear(256, 512), nn.ReLU(),
                            nn.Linear(512, 16))
        if state is None:
            state = {k: v.numpy() for k, v in net.state_dict().items()}
        check(net.set_state_dict(state) == [], "27d: weights")
        return net

    def both(fn):
        out = {}
        for flag in (True, False):
            paddle.set_flags({"FLAGS_lazy_eager": flag})
            try:
                out[flag] = fn()
            finally:
                paddle.set_flags({"FLAGS_lazy_eager": True})
        return out[True], out[False]

    def early_read():
        net = mlp()
        opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
        x = paddle.to_tensor(x_np)
        losses = []
        for _ in range(n):
            loss = net(x).square().mean()
            losses.append(float(loss))
            loss.backward()
            opt.step()
            opt.clear_grad()
        return losses

    before = lazy.stats["eager"]
    got, want = both(early_read)
    eager = lazy.stats["eager"] - before
    check(got == want and eager == 2 * n, f"27d: float(loss) before "
          f"backward: losses {got} vs {want}, {eager} node-by-node flushes "
          f"(want {2 * n})")
    print(f"    a float(loss) before backward(): {n} steps, immediate's "
          f"bits, {eager} segments replayed node by node and counted (the "
          f"forward and the backward + step of each)")

    def inf_step():
        net = mlp()
        opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
        scaler = paddle.amp.GradScaler(init_loss_scaling=8.0)
        w0 = net[0].weight.numpy().copy()
        big = paddle.to_tensor(np.full((2, 256), 3e38, np.float32))
        scaler.scale((net(big) * 1e30).sum()).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return (np.array_equal(net[0].weight.numpy(), w0),
                float(scaler._scale))

    got, want = both(inf_step)
    check(got == want and got[0] and got[1] < 8.0,
          f"27d: the inf step {got} vs {want}")
    print(f"    GradScaler: the inf step skipped (weights unchanged), the "
          f"scale backed off to {got[1]}, as immediately")

    def dropout_masks(seed):
        net = mlp()
        opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
        x = paddle.to_tensor(x_np)
        paddle.seed(seed)
        masks = []
        for _ in range(n):
            h = F.dropout(paddle.ones([64, 16]), 0.5)
            (net(x) * h).sum().backward()
            opt.step()
            opt.clear_grad()
            masks.append(h.value != 0)
        return masks

    seen = lazy.flushes[0]
    got, want = both(lambda: dropout_masks(5))
    forms = lazy.forms_since(seen)
    fresh = all(not torch.equal(got[i], got[i + 1]) for i in range(n - 1))
    check(all(torch.equal(a, b) for a, b in zip(got, want)) and fresh
          and "replay" in forms, f"27d: dropout masks (lazy forms {forms})")
    print(f"    dropout: {n} steps' masks (captured from step 3: "
          f"{forms[:n]}) new at every replay and the immediate masks of "
          f"the same seed")

    y = paddle.to_tensor(x_np) * 2.0
    z = paddle.masked_select(y, y > 1.0)
    check(not lazy.pending() and z.value.is_cuda and np.array_equal(
        z.numpy(), (x_np * 2)[x_np * 2 > 1.0]), "27d: masked_select")
    base = paddle.zeros([4, 8])
    view = base.reshape([32])
    view[5] = 7.0
    check(base.numpy()[0, 5] == 7.0 and base.value.is_cuda,
          "27d: a write through a view")
    print("    masked_select ran after the pending graph (on the card); a "
          "write through a view reached its source")

    def set_value_between():
        net = mlp()
        opt = paddle.optimizer.SGD(0.1, parameters=net.parameters())
        x = paddle.to_tensor(x_np)
        for i in range(n):
            net(x).square().mean().backward()
            opt.step()
            opt.clear_grad()
            if i == 3:
                net[2].bias.set_value(np.full(16, 0.5, np.float32))
        return {k: v.numpy() for k, v in net.state_dict().items()}

    def step_decay():
        net = mlp()
        sched = paddle.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
        opt = paddle.optimizer.Momentum(sched, parameters=net.parameters())
        x = paddle.to_tensor(x_np)
        for _ in range(n):
            net(x).square().mean().backward()
            opt.step()
            opt.clear_grad()
            sched.step()
        return {k: v.numpy() for k, v in net.state_dict().items()}

    for label, fn in (("a set_value between steps", set_value_between),
                      ("a StepDecay stepped between replays", step_decay)):
        seen = lazy.flushes[0]
        got, want = both(fn)
        forms = lazy.forms_since(seen)
        check(all(np.array_equal(got[k], want[k]) for k in want)
              and "replay" in forms, f"27d: {label} (forms {forms})")
        print(f"    {label}: immediate's weights bit for bit after {n} "
              f"steps (replays {forms.count('replay')})")

    xg = paddle.to_tensor(np.asarray([3.0], np.float32), stop_gradient=False)
    (g1,) = paddle.grad(xg * xg * xg, xg, create_graph=True)
    ran = not lazy.pending() and not isinstance(g1._v, lazy.LazyArray)
    (g2,) = paddle.grad(g1, xg)
    check(ran and float(g1) == 27.0 and float(g2) == 18.0,
          f"27d: create_graph {float(g1)}, {float(g2)}")
    print("    paddle.grad(create_graph=True) ran at once: 27 and 18")
    lazy_release(torch)


def lazy_tools(torch, paddle, attn, run):
    """27e: _C_ops on the card against the ops; a Profiler with a
    scheduler over three of 27a's lazy steps: its chrome trace holds the
    optimizer/step spans and K1-K3's kernels; record_scope's counters
    move."""
    from paddle_tpu_torch import _C_ops, profiler
    from paddle_tpu_torch.observability import registry
    g = torch.Generator().manual_seed(27)
    a, b_ = (paddle.to_tensor(torch.randn(64, 128, generator=g).numpy())
             for _ in range(2))
    mm = _C_ops.matmul_v2(a, b_, "trans_x", False, "trans_y", True)
    sm = _C_ops.softmax(a, "axis", -1)
    check(mm.value.is_cuda and torch.equal(
        mm.value, paddle.matmul(a, b_, transpose_y=True).value)
        and torch.equal(sm.value, paddle.nn.functional.softmax(a).value),
        "27e: _C_ops against the ops")
    calls = registry.default_registry().counter(
        "host_span_calls_total", labelnames=("span",)).labels(
            "optimizer/step")
    before = calls.value
    # the window: step 1 closed, steps 2-4 (record, capture, replay)
    lazy_release(torch)
    import tempfile
    with tempfile.TemporaryDirectory() as out_dir:
        prof = profiler.Profiler(
            scheduler=profiler.make_scheduler(closed=1, ready=0, record=3,
                                              repeat=1),
            on_trace_ready=profiler.export_chrome_tracing(out_dir, "lazy"))
        prof.start()
        for _ in range(5):
            run["step"]()
            prof.step()
        prof.stop()
        with open(prof.traces[0]) as fh:
            events = [e.get("name", "")
                      for e in json.load(fh)["traceEvents"]]
    names = set(events)
    spans = events.count("optimizer/step")
    kernels = {k: any(k in n for n in names)
               for k in ("flash_fwd_f32_kernel", "flash_bwd_dq_f32_kernel",
                         "flash_bwd_dkv_f32_kernel")}
    moved = calls.value - before
    check(spans and all(kernels.values()) and moved == 5,
          f"27e: trace spans {spans}, kernels {kernels}, optimizer/step "
          f"calls moved {moved}")
    k1 = sum(1 for n in events if "flash_fwd_f32_kernel" in n)
    print(f"    _C_ops.matmul_v2 / softmax on the card: the ops' bits; a "
          f"Profiler over 3 lazy steps (record, capture, replay) wrote a "
          f"chrome trace with {spans} optimizer/step spans and K1-K3's "
          f"kernels {sorted(kernels)} (K1 events {k1}: a replayed graph's "
          f"launches appear by name when that is more than 12); "
          f"record_scope('optimizer/step') calls +{moved}")


def phase_lazy(torch, attn, amp, cfg):
    """Phase 27, the lazy eager executor on the card (27a-27e). Returns
    27a's and 27c's (K1, K2, K3) launches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import device as device_mod
    try:
        paddle.set_device("gpu")
        lazy_release(torch, "before phase 27")
        print("  [27a] the surface GPT-124M, a plain eager loop, lazy "
              "against immediate")
        gpt, run = lazy_gpt(torch, attn, cfg)
        print("  [27e] _C_ops and the profiler")
        lazy_tools(torch, paddle, attn, run)
        del run
        lazy_release(torch)
        print("  [27b] config 1 (LeNet): lazy, immediate, to_static")
        lazy_lenet(torch, paddle)
        lazy_release(torch)
        print("  [27c] config 3 (BERT-base, O1 bf16) in the Paddle surface")
        bert = lazy_bert(torch, attn, amp)
        print("  [27d] edge cases")
        lazy_edges(torch, paddle)
        return gpt, bert
    finally:
        device_mod._current_place = None
        paddle.set_flags({"FLAGS_lazy_eager": True})
        lazy_release(torch, "after phase 27")


# --------------------------------------------------------------- phase 28

# phase 28: the distributed layer. 28b/28c run 2 rank processes on the one
# card over gloo (NCCL refuses two ranks on one device, which 28b checks);
# the f32 TP step's losses are held to the one-process run's at
# TP_LOSS_RTOL (the ranks' partial products summed in another order); the
# bf16 O1 step's at TP_BF16_LOSS_RTOL: each row-parallel output is the sum
# of the ranks' two bf16 partials, rounded to bf16 once more than the
# dense product; sound runs read 1.5e-5 on the card. The loss at init is
# about ln V whatever the model, so one process's f32 and O1 losses read
# only 4e-5 apart: no loss bound tells a run in the other precision from a
# sound one, and the bound (7x the sound readings) is for structural
# faults, which move the model's part of the loss (5e-3 to 8e-2 of it
# over the steps). A slip to f32 is checked apart: the ranks' O1 losses
# must differ from their f32 losses by more than TP_O1_FROM_F32 (f32
# paths read 1.8e-7 apart, O1 2.5e-5 from f32). After 3 f32 AdamW steps each gathered leaf
# is held to the one-process run's by the norm of the difference over the
# norm of the leaf's own update, within TP_WEIGHT_RTOL: Adam normalises
# each element's grad, so among 124M elements those whose grad is near 0
# move by up to 0.2 lr apart on a sound run (the largest element reads
# 1.9e-5 at lr 1e-4), while a wrong or missing update moves a whole leaf
# by about its update. The key third of each QKV bias has a grad of 0 (a
# key bias shifts every score of a query alike), so its update is
# rounding noise, up to about lr a step either way: within
# TP_KBIAS_STEPS x lr
DIST = dict(batch=8, seq=1024, steps=3, lr=1e-4, timeout=900)
TP_LOSS_RTOL = 1e-4
TP_BF16_LOSS_RTOL = 1e-4
TP_O1_FROM_F32 = 2e-6
TP_WEIGHT_RTOL = 1e-2
TP_KBIAS_STEPS = 2 * DIST["steps"]
# 28f: greedy decoding of the use_mp GPT-124M on each rank against one
# process's dense model from the same weights
TPGEN = dict(prompts=4, prompt_len=16, new=32, slots=4, block=16)
TPGEN_AGREE = 0.9    # the forward's argmax against the decoded tokens
SP_SHAPE = (8, 12, 1024, 64)
# 28c: Ulysses runs K1-K3 on 6 of 12 heads (the f32 K1 may split the keys
# otherwise at that grid, so the sums run in another order); the ring is
# the plain online softmax in f32 against the flash kernels: each within
# this share of its tensor's largest element
SP_TOL = 1e-4
TP_SHARD_T, TP_SHARD_H, TP_SHARD_V = 8192, 768, 50304


def dist_gpt(torch, TransformerLMConfig, GPTForCausalLM, **knobs):
    cfg = TransformerLMConfig(dropout=0.0, max_seq_len=DIST["seq"], **knobs)
    return GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        2024)).train()


def dist_steps(torch, amp, optimizer, model, dtype, steps=DIST["steps"]):
    """``steps`` AdamW steps of phase 10's batch (8 x 1024, labels = ids),
    f32 or under O1 bf16; the losses."""
    vocab = getattr(model, "_layers", model).cfg.vocab_size
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, vocab, (DIST["batch"], DIST["seq"])).astype(np.int64)).cuda()
    opt = optimizer.AdamW(DIST["lr"], parameters=model.named_parameters(),
                          weight_decay=0.01)
    from paddle_tpu_torch.distributed import fleet, topology
    if topology.get_hybrid_communicate_group() is not None:
        opt = fleet.distributed_optimizer(opt)
    losses = []
    for _ in range(steps):
        with (amp.auto_cast(level="O1", dtype="bfloat16")
              if dtype == "bfloat16" else contextlib.nullcontext()):
            loss = model(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    return losses


def sp_inputs(torch):
    g = torch.Generator().manual_seed(28)
    return [torch.randn(SP_SHAPE, generator=g) for _ in range(4)]


def tp_decode(torch, model):
    """28f on one process (a TP rank, or the dense model in the parent):
    greedy generate() of TPGEN["new"] tokens from the seeded prompts, the
    teacher-forced forward over them (K1: on a rank, its heads' share),
    and the ServingEngine's greedy streams (K4 on the paged decode).
    Every rank of an mp group must call it."""
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import ServingEngine
    model.eval()
    p = TPGEN["prompt_len"]
    prompts = np.random.RandomState(28).randint(
        0, model.cfg.vocab_size, (TPGEN["prompts"], p)).astype(np.int64)
    toks = model.generate(torch.from_numpy(prompts).cuda(),
                          max_new_tokens=TPGEN["new"], temperature=0.0)
    attn.flash_attention_forward.launches = 0
    with torch.no_grad():
        logits = model(toks[:, :-1])
    torch.cuda.synchronize()
    k1 = attn.flash_attention_forward.launches
    agree = float((logits[:, p - 1:].argmax(-1) == toks[:, p:]).float()
                  .mean())
    eng = ServingEngine(model, num_slots=TPGEN["slots"],
                        block_size=TPGEN["block"], async_depth=1)
    pa.paged_decode_attention.launches = 0
    reqs = [eng.add_request(q, max_new_tokens=TPGEN["new"])
            for q in prompts]
    eng.run()
    torch.cuda.synchronize()
    return {"tokens": toks[:, p:].cpu().tolist(),
            "engine": [[int(t) for t in r.generated] for r in reqs],
            "k1": k1, "k4": pa.paged_decode_attention.launches,
            "steps": eng.metrics.decode_steps, "agree": agree,
            "k1_shape": [TPGEN["prompts"],
                         getattr(model.gpt.blocks[0].attn, "local_heads",
                                 model.cfg.num_heads),
                         p + TPGEN["new"] - 1,
                         model.cfg.hidden_size // model.cfg.num_heads]}


def k4_row_at(torch, pa, S, lengths, label, nh=12, hd=64):
    """K4 at a decode shape of an engine's (GPT-124M's 12 heads of 64 by
    default, blocks of TPGEN["block"]): against its plain version,
    timed, its bound."""
    BS = TPGEN["block"]
    MB = -(-max(lengths) // BS)
    args = paged_case(torch, S, nh, hd, BS, MB, lengths, "float32", 28)
    err = k4_case(torch, pa, label, args, F32_TOL)
    ms = time_ms(torch, lambda: pa.paged_decode_attention(*args))
    plain_ms = time_ms(torch, lambda: pa.paged_decode_plain(*args))
    rows = sum(lengths)
    row_bytes = nh * hd * 4
    nbytes = 2 * S * row_bytes + 2 * rows * row_bytes + args[3].numel() * 4 \
        + S * 4
    b_ms, b_by = bound(nbytes, 4 * rows * nh * hd, "float32")
    print(f"  K4 {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by})")
    return {"name": "paged_decode_attention", "route": "cuda",
            "dtype": "float32",
            "shape": f"{label} S={S} nh={nh} hd={hd} BS={BS} "
                     f"lengths={lengths}",
            "source": "paddle_tpu_torch/csrc/paged_decode.cu",
            "replaces": "paddle_tpu/ops/paged_attention.py:92",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def dist_rank(rank, world, port, outdir, queue, nccl=False):
    """One rank of 28b/28c (a spawned process on the card): the TP
    GPT-124M at mp = 2, f32 then O1 bf16, 3 AdamW steps each; then sp =
    2, Ulysses and ring attention at SP_SHAPE against nothing here (the
    parent compares the blocks it writes). With ``nccl``: only try an
    NCCL group of the two ranks on the one card and report."""
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(world),
                      PADDLE_TRAINER_ENDPOINTS=f"127.0.0.1:{port}")
    try:
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        sys.path.insert(0, HERE)
        from paddle_tpu_torch.distributed import init_parallel_env
        if nccl:
            import torch.distributed as dist
            try:
                init_parallel_env(backend="nccl", timeout=60)
                x = torch.ones(4, device="cuda")
                dist.all_reduce(x)
                torch.cuda.synchronize()
                queue.put((rank, {"nccl": f"took two ranks: {x.tolist()}"}))
            except Exception as e:  # noqa: BLE001 - reported, not passed
                queue.put((rank, {"nccl": f"{type(e).__name__}: "
                                  f"{str(e).splitlines()[0][:200]}"}))
            if dist.is_initialized():
                dist.destroy_process_group()
            return
        queue.put((rank, _dist_rank(torch, world, outdir)))
    except BaseException as e:  # noqa: BLE001 - the parent raises it
        import traceback
        queue.put((rank, {"error": traceback.format_exc()[-3000:]}))
        raise


def _dist_rank(torch, world, outdir):
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch.distributed import (collective, fleet,
                                              init_parallel_env, topology)
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import fused_ce as tce
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              TransformerLMConfig)
    env = init_parallel_env(timeout=120)
    out = {"backend": collective._default_group().backend}
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"mp_degree": world}
    fleet.init(is_collective=True, strategy=s)
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv, tce.fused_ce_forward, tce.fused_ce_bwd_dx,
                tce.fused_ce_bwd_dw)
    for dtype in ("float32", "bfloat16"):
        model = fleet.distributed_model(dist_gpt(
            torch, TransformerLMConfig, GPTForCausalLM, use_mp=True))
        layers = model._layers
        torch.cuda.synchronize()
        for fn in wrappers:
            fn.launches = 0
        t0 = time.perf_counter()
        losses = dist_steps(torch, amp, optimizer, model, dtype)
        torch.cuda.synchronize()
        out[f"{dtype}_s"] = time.perf_counter() - t0
        out[f"{dtype}_launches"] = [fn.launches for fn in wrappers]
        out[f"{dtype}_losses"] = losses
        out[f"{dtype}_heads"] = layers.gpt.blocks[0].attn.local_heads
        out[f"{dtype}_vocab"] = layers.gpt.word_embeddings.weight.shape[0]
        if dtype == "float32":
            state = {k: v.cpu() for k, v in
                     mp_layers.full_tensors(layers).items()}
            if env.rank == 0:
                torch.save(state, os.path.join(outdir, "tp_state.pt"))
            del state
        del model, layers
        torch.cuda.empty_cache()
    out["staged"] = dict(collective.host_staged)
    # 28f: the use_mp GPT-124M decoding greedily on each rank
    tp = dist_gpt(torch, TransformerLMConfig, GPTForCausalLM, use_mp=True)
    out["tpgen"] = tp_decode(torch, tp)
    del tp
    torch.cuda.empty_cache()
    # 28c: sequence parallelism over the same two ranks
    topology.reset()
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"sp_degree": world}
    fleet.init(is_collective=True, strategy=s)
    g = fleet.get_hybrid_communicate_group().get_sequence_parallel_group()
    q, k, v, cot = sp_inputs(torch)
    blk = SP_SHAPE[2] // world
    mine = slice(g.rank * blk, (g.rank + 1) * blk)
    got = {}
    for mode, fn in (("ulysses", ra.ulysses_attention),
                     ("ring", ra.ring_attention)):
        qt, kt, vt = (t[:, :, mine].contiguous().cuda().requires_grad_()
                      for t in (q, k, v))
        for w in wrappers:
            w.launches = 0
        o = fn(qt, kt, vt, g, causal=True)
        (o * cot[:, :, mine].cuda()).sum().backward()
        torch.cuda.synchronize()
        out[f"{mode}_launches"] = [w.launches for w in wrappers[:3]]
        got[mode] = {"o": o.detach().cpu(), "dq": qt.grad.cpu(),
                     "dk": kt.grad.cpu(), "dv": vt.grad.cpu()}
    torch.save(got, os.path.join(outdir, f"sp_rank{g.rank}.pt"))
    out["sp_rank"] = g.rank
    out["staged_after_sp"] = dict(collective.host_staged)
    import torch.distributed as dist
    dist.destroy_process_group()
    return out


def spawn_ranks(world, outdir, nccl=False, timeout=DIST["timeout"]):
    """``world`` rank processes (spawn, never fork) running dist_rank;
    their results by rank. Every process is joined or killed. With
    ``nccl`` (a probe whose outcome is reported, not checked) a rank that
    gives no result in ``timeout`` or dies is reported as such."""
    import multiprocessing as mp
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=dist_rank,
                         args=(r, world, port, outdir, queue, nccl))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.time() + timeout
    try:
        while len(results) < world:
            left = deadline - time.time()
            if left <= 0 and nccl:
                break
            check(left > 0, f"28: ranks "
                  f"{sorted(set(range(world)) - set(results))} gave no "
                  f"result in {timeout} s")
            try:
                rank, res = queue.get(timeout=min(left, 10))
            except Exception:  # noqa: BLE001 - queue.Empty: poll again
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and nccl:
                    break
                check(not dead, f"28: a rank exited {dead} without a result")
                continue
            results[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    for r, res in results.items():
        check("error" not in res, f"28: rank {r} failed:\n{res.get('error')}")
    return [results.get(r, {"nccl": f"no answer (exit code "
                               f"{procs[r].exitcode})"})
            for r in range(world)]


def phase_dist_world1(torch, TransformerLMConfig, GPTForCausalLM):
    """28a: a world of one over NCCL on the card: every collective is the
    identity on a CUDA tensor, NCCL's own all_reduce runs, and a
    DataParallel GPT-124M f32 step gives the plain step's loss and grads
    bit for bit."""
    import torch.distributed as dist
    from paddle_tpu_torch.distributed import (DataParallel, collective,
                                              init_parallel_env, topology)
    env = init_parallel_env()
    backend = collective._default_group().backend or dist.get_backend()
    check(backend == "nccl", f"28a: a world of one on the card runs "
          f"{backend}, not NCCL")
    x = torch.randn(4, 6, device="cuda")
    C = collective
    outs = {
        "all_reduce": C.all_reduce(x.clone()),
        "all_gather": C.all_gather([], x.clone())[0],
        "broadcast": C.broadcast(x.clone()),
        "reduce": C.reduce(x.clone(), dst=0),
        "scatter": C.scatter(torch.zeros_like(x), [x.clone()]),
        "alltoall": C.alltoall([x.clone()])[0],
        "reduce_scatter": C.reduce_scatter(torch.zeros_like(x), [x.clone()]),
        "_c_identity": C._c_identity(x.clone()),
        "_mp_allreduce": C._mp_allreduce(x.clone())}
    C.send(x.clone(), dst=0)
    outs["send/recv"] = C.recv(torch.zeros_like(x), src=0)
    for name, o in outs.items():
        check(o.is_cuda and torch.equal(o, x), f"28a: {name} is not the "
              "identity in a world of one")
    y = x.clone()
    dist.all_reduce(y)
    torch.cuda.synchronize()
    check(torch.equal(y, x), "28a: NCCL's all_reduce of one rank changed it")
    C.barrier()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 50304, (DIST["batch"], DIST["seq"])).astype(np.int64)).cuda()
    got = []
    for wrap in (False, True):
        model = dist_gpt(torch, TransformerLMConfig, GPTForCausalLM)
        m = DataParallel(model) if wrap else model
        loss = m(ids, labels=ids)
        loss.backward()
        torch.cuda.synchronize()
        got.append((loss.item(), {n: p.grad.clone() for n, p in
                                  model.named_parameters()}))
        del model, m, loss
    same = got[0][0] == got[1][0] and all(
        torch.equal(a, got[1][1][n]) for n, a in got[0][1].items())
    check(same, "28a: the DataParallel step differs from the plain step")
    del got
    torch.cuda.empty_cache()
    print(f"  28a world of one over {backend} (rank {env.rank} of "
          f"{env.world_size}): {len(outs)} collectives the identity on a "
          f"CUDA tensor, NCCL's all_reduce ran; DataParallel GPT-124M f32 "
          f"step = the plain step's loss and every grad, bit for bit")
    dist.destroy_process_group()
    collective.reset()
    topology.reset()


def phase_dist_ranks(torch, amp, optimizer, TransformerLMConfig,
                     GPTForCausalLM, attn):
    """28b/28c: the two-rank TP GPT-124M and sequence parallelism,
    against one process on the card."""
    import tempfile
    res = spawn_ranks(2, tempfile.gettempdir(), nccl=True, timeout=180)
    nccl = [r["nccl"] for r in res]
    print(f"  28b two NCCL ranks on the one card: rank 0 {nccl[0]}; rank 1 "
          f"{nccl[1]}")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as outdir:
        t0 = time.perf_counter()
        ranks = spawn_ranks(2, outdir)
        spawn_s = time.perf_counter() - t0
        check(all(r["backend"] == "gloo" for r in ranks),
              f"28b: backends {[r['backend'] for r in ranks]}")
        L = 12
        for dtype in ("float32", "bfloat16"):
            a, b = (r[f"{dtype}_losses"] for r in ranks)
            check(a == b, f"28b {dtype}: the ranks' losses differ: {a} {b}")
            for r in ranks:
                check(r[f"{dtype}_launches"] == [DIST["steps"] * L] * 3
                      + [DIST["steps"]] * 3,
                      f"28b {dtype}: launches {r[f'{dtype}_launches']}")
                check((r[f"{dtype}_heads"], r[f"{dtype}_vocab"])
                      == (6, 25152), "28b: not 6 heads and 25152 rows a rank")
        # one process, the same weights and batch
        want = {}
        for dtype in ("float32", "bfloat16"):
            model = dist_gpt(torch, TransformerLMConfig, GPTForCausalLM)
            init = {n: p.detach().cpu().clone()
                    for n, p in model.named_parameters()}
            t1 = time.perf_counter()
            want[dtype] = dist_steps(torch, amp, optimizer, model, dtype)
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t1
            tol = TP_LOSS_RTOL if dtype == "float32" else TP_BF16_LOSS_RTOL
            got = ranks[0][f"{dtype}_losses"]
            rel = [abs(x - y) / abs(y) for x, y in zip(got, want[dtype])]
            check(max(rel) <= tol, f"28b {dtype}: losses {got} against one "
                  f"process's {want[dtype]}: {max(rel)} > {tol}")
            print(f"  28b GPT-124M mp = 2 {dtype}: losses {got} (both ranks "
                  f"equal), one process {want[dtype]}, largest relative "
                  f"difference {max(rel):.3e} (tol {tol}); 3 steps "
                  f"{ranks[0][f'{dtype}_s']:.2f} s on the ranks, "
                  f"{one_s:.2f} s in one process")
            if dtype == "float32":
                tp = torch.load(os.path.join(outdir, "tp_state.pt"))
                check(set(tp) == {n for n, _ in model.named_parameters()},
                      "28b: the gathered state's keys")
                final = {n: p.detach().cpu().clone()
                         for n, p in model.named_parameters()}
                tp_leaves_check(torch, "28b TP", tp, final, init)
                # phase 29 holds its pipeline and ZeRO runs to this run
                one = {"losses": want["float32"], "final": final,
                       "init": init}
                del tp
            del model, init
            torch.cuda.empty_cache()
        control = max(abs(x - y) / abs(y) for x, y in
                      zip(want["bfloat16"], want["float32"]))
        slip = max(abs(x - y) / abs(y) for x, y in
                   zip(ranks[0]["bfloat16_losses"],
                       ranks[0]["float32_losses"]))
        print(f"  28b controls: one process's O1 losses against its f32 "
              f"losses {control:.3e}; the ranks' O1 losses against their "
              f"f32 losses {slip:.3e} (must exceed {TP_O1_FROM_F32})")
        check(slip > TP_O1_FROM_F32, f"28b: the ranks' O1 losses are their "
              f"f32 losses within {slip}: O1 did not run")
        staged = ranks[0]["staged"]
        print(f"  28b host-staged collectives (gloo takes CUDA tensors in "
              f"all_reduce and broadcast only): {staged}; the spawn "
              f"{spawn_s:.1f} s")
        # 28f: each rank's greedy tokens against one process's dense
        # GPT-124M from the same weights
        dense = dist_gpt(torch, TransformerLMConfig, GPTForCausalLM)
        want = tp_decode(torch, dense)
        del dense
        torch.cuda.empty_cache()
        for r, res in enumerate(ranks):
            got = res["tpgen"]
            check(got["tokens"] == want["tokens"], f"28f rank {r}: "
                  f"generate() tokens differ from one process's")
            check(got["engine"] == want["tokens"], f"28f rank {r}: the "
                  f"engine's streams differ from one process's tokens")
            check(got["agree"] >= TPGEN_AGREE and got["k4"] == got["steps"]
                  * 12 and got["k1"] == 12, f"28f rank {r}: agree "
                  f"{got['agree']}, K1 {got['k1']}, K4 {got['k4']} over "
                  f"{got['steps']} steps")
        tpgen = [r["tpgen"] for r in ranks]
        print(f"  28f GPT-124M use_mp mp = 2: greedy generate() of "
              f"{TPGEN['new']} tokens from {TPGEN['prompts']} prompts of "
              f"{TPGEN['prompt_len']} on each rank = one process's dense "
              f"tokens, and so is each rank's ServingEngine stream; the "
              f"teacher-forced forward's argmax agrees on "
              f"{[t['agree'] for t in tpgen]} of them; K1 a rank "
              f"{[t['k1'] for t in tpgen]} at {tpgen[0]['k1_shape']}, "
              f"K4 a rank {[t['k4'] for t in tpgen]} over "
              f"{[t['steps'] for t in tpgen]} decode steps (one process: "
              f"K1 {want['k1']}, K4 {want['k4']})")
        # 28c against one process's flash attention on the card
        q, k, v, cot = (t.cuda() for t in sp_inputs(torch))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = attn.scaled_dot_product_attention(*leaves, is_causal=True)
        (o * cot).sum().backward()
        want = {"o": o.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad,
                "dv": leaves[2].grad}
        blocks = [torch.load(os.path.join(outdir, f"sp_rank{r}.pt"))
                  for r in range(2)]
        for mode in ("ulysses", "ring"):
            errs = []
            for name, w in want.items():
                top = float(w.abs().max())
                err = max(float((blocks[r][mode][name].cuda()
                                 - w.chunk(2, dim=2)[r]).abs().max())
                          for r in range(2))
                check(err <= SP_TOL * top, f"28c {mode} {name}: err {err} > "
                      f"{SP_TOL} x {top}")
                errs.append(f"{name} {err:.3e}")
            launches = [sum(x) for x in zip(*(r[f"{mode}_launches"]
                                              for r in ranks))]
            print(f"  28c sp = 2 {mode} causal at {list(SP_SHAPE)}: against "
                  f"one process's flash attention: {', '.join(errs)} (tol "
                  f"{SP_TOL} of each largest); K1/K2/K3 launches {launches}")
        check([sum(x) for x in zip(*(r["ulysses_launches"] for r in ranks))]
              == [2, 2, 2], "28c: Ulysses did not run K1-K3 once a rank")
        check([sum(x) for x in zip(*(r["ring_launches"] for r in ranks))]
              == [0, 0, 0], "28c: the ring ran a flash kernel")
        print(f"  28c host-staged collectives after sp: "
              f"{ranks[0]['staged_after_sp']}")
        del q, k, v, cot, leaves, o, want, blocks
        torch.cuda.empty_cache()
    f32 = [sum(x) for x in zip(*(r["float32_launches"] for r in ranks))]
    bf16 = [sum(x) for x in zip(*(r["bfloat16_launches"] for r in ranks))]
    uly = [sum(x) for x in zip(*(r["ulysses_launches"] for r in ranks))]
    return f32, bf16, uly, one, tpgen


def tp_leaves_check(torch, label, tp, final, init):
    """28b and 29: each gathered leaf of a run over ranks after the f32
    steps (``tp``) against the one-process run's (``final``): the norm of
    their difference within TP_WEIGHT_RTOL of the norm of the leaf's own
    update in the one-process run (``init`` the weights before it), and
    the QKV biases' key thirds, whose update is noise, within
    TP_KBIAS_STEPS x lr of each other; prints, for each kind of leaf over
    the layers, the largest of those shares and the largest element
    difference."""
    h = final["gpt.position_embeddings.weight"].shape[1]
    lr = DIST["lr"]
    kinds, bad = {}, []
    kbias = 0.0
    for n, one in final.items():
        diff, move = tp[n].cpu() - one, one - init[n]
        if n.endswith("attn.qkv.bias"):
            kb = float(diff[h:2 * h].abs().max())
            kbias = max(kbias, kb)
            if kb > TP_KBIAS_STEPS * lr:
                bad.append(f"{n}[{h}:{2 * h}] {kb:.3e}")
            keep = torch.cat([torch.arange(h), torch.arange(2 * h, 3 * h)])
            diff, move = diff[keep], move[keep]
        share = float(diff.norm() / move.norm())
        kind = re.sub(r"\.\d+\.", ".*.", n)
        top, el = kinds.get(kind, (0.0, 0.0))
        kinds[kind] = (max(top, share), max(el, float(diff.abs().max())))
        if not share <= TP_WEIGHT_RTOL:
            bad.append(f"{n} {share:.3e}")
    print(f"  {label}: the gathered state after 3 steps, for each leaf |"
          f"ranks - one process| / |one process's update| (tol "
          f"{TP_WEIGHT_RTOL}) and "
          f"the largest element difference (lr {lr}): "
          + ", ".join(f"{k} {v[0]:.3e} / {v[1]:.3e}"
                      for k, v in kinds.items())
          + f"; the key thirds of the QKV biases {kbias:.3e} (tol "
          f"{TP_KBIAS_STEPS} x lr)")
    check(not bad, f"{label}: gathered leaves off the one-process run: "
          f"{bad}")


def phase_tp_shards(torch, tce):
    """28d: the TP shard route of K5-K7 in one process: for mp = 2 and 4
    over V = 50304, each shard's K5 with its shifted labels and K6/K7
    with the global LSE against their plain versions on the same inputs
    (these errors are the rows' max_abs_err); then the shards combined
    against the full-vocab K5 (loss and LSE), K6's dx (summed over the
    shards) and K7's dW slice; f32 and bf16; each shard call timed with
    its bound and F.cross_entropy(F.linear) on the same shard. Returns
    the mp = 2 rows (the shape 28b runs) for the kernels line and prints
    the mp = 4 rows on a line of their own."""
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(28)
    T, H, V = TP_SHARD_T, TP_SHARD_H, TP_SHARD_V
    rows = []
    for dtype in ("float32", "bfloat16"):
        x, w, labels, gg = ce_case(torch, T, H, V, dtype, g)
        loss, lse = tce.fused_ce_forward(x, w, labels)
        dx = tce.fused_ce_bwd_dx(x, w, labels, lse, gg)
        dw = tce.fused_ce_bwd_dw(x, w, labels, lse, gg)
        gtol = CE_F32_TOL if dtype == "float32" else CE_BF16_TOL
        # the shard's K6/K7 against the plain backward: d kept f32 (f32),
        # or rounded to bf16 as the kernels round it (bf16)
        d_dtype, ptol = ((None, CE_F32_TOL) if dtype == "float32"
                         else (torch.bfloat16, CE_BF16D_TOL))
        for mp in (2, 4):
            vl = V // mp
            parts = []
            for r in range(mp):
                shifted, valid = tce._tp_shift(labels, -100, r, vl)
                wr = w[r * vl:(r + 1) * vl].contiguous()
                parts.append((wr, shifted,
                              tce.fused_ce_forward(x, wr, shifted,
                                                   tce._NEVER)))
            lses = torch.stack([p[2][1] for p in parts])
            m = lses.max(0).values
            lse_g = m + torch.log(torch.exp(lses - m).sum(0))
            ll = sum(p[2][1] - p[2][0] for p in parts)
            tloss = torch.where(valid, lse_g - ll, torch.zeros_like(lse_g))
            el = max(float((tloss - loss).abs().max()),
                     float((lse_g - lse).abs().max()))
            check(el <= CE_LOSS_TOL, f"28d mp {mp} {dtype}: loss/LSE err "
                  f"{el} > {CE_LOSS_TOL}")
            g_eff = (gg * valid.float()).contiguous()
            tdx = None
            edw = 0.0
            e5 = e6 = e7 = 0.0
            for r, (wr, shifted, (lr_, lser)) in enumerate(parts):
                pl, plse = tce.tp_local_forward_plain(x.float(), wr.float(),
                                                      shifted)
                # the loss of the rows the combine keeps: on an ignored row
                # rank 0's K5 gives 0 (its label is the ignored sentinel)
                # and the plain version, as the reference's composition,
                # the LSE; the combine masks both
                e5 = max(e5, float((lr_ - pl)[valid].abs().max()),
                         float((lser - plse).abs().max()))
                d = tce.fused_ce_bwd_dx(x, wr, shifted, lse_g, g_eff,
                                        tce._NEVER)
                dwr = tce.fused_ce_bwd_dw(x, wr, shifted, lse_g, g_eff,
                                          tce._NEVER)
                rdx, rdw = tce.fused_linear_cross_entropy_backward_plain(
                    x.float(), wr.float(), shifted, lse_g, g_eff, tce._NEVER,
                    d_dtype=d_dtype)
                for name, got, want_ in (("K6 dx", d, rdx), ("K7 dW", dwr,
                                                               rdw)):
                    err = float((got.float() - want_).abs().max())
                    top = float(want_.abs().max())
                    check(bool(torch.isfinite(got).all())
                          and err <= ptol * top,
                          f"28d mp {mp} {dtype} shard {r} {name}: err {err} "
                          f"> {ptol} x {top} against its plain version")
                    if name == "K6 dx":
                        e6 = max(e6, err)
                    else:
                        e7 = max(e7, err)
                del pl, plse, rdx, rdw
                d = d.float()
                tdx = d if tdx is None else tdx + d
                edw = max(edw, float((dwr.float() - dw[r * vl:(r + 1) * vl]
                                      .float()).abs().max()))
            check(e5 <= CE_LOSS_TOL, f"28d mp {mp} {dtype}: a shard's K5 "
                  f"loss/LSE err {e5} > {CE_LOSS_TOL} against its plain "
                  f"version")
            edx = float((tdx - dx.float()).abs().max())
            tdx_top = float(dx.float().abs().max())
            dw_top = float(dw.float().abs().max())
            check(edx <= gtol * tdx_top and edw <= gtol * dw_top,
                  f"28d mp {mp} {dtype}: dx err {edx}, dW err {edw} (tol "
                  f"{gtol} of {tdx_top} / {dw_top})")
            # times of rank 0's shard calls
            wr, shifted, _ = parts[0]
            k5 = time_ms(torch, lambda: tce.fused_ce_forward(
                x, wr, shifted, tce._NEVER), iters=10, warmup=2)
            k6 = time_ms(torch, lambda: tce.fused_ce_bwd_dx(
                x, wr, shifted, lse_g, g_eff, tce._NEVER), iters=10, warmup=2)
            k7 = time_ms(torch, lambda: tce.fused_ce_bwd_dw(
                x, wr, shifted, lse_g, g_eff, tce._NEVER), iters=10, warmup=2)
            pf = time_ms(torch, lambda: tce.tp_local_forward_plain(
                x, wr, shifted), iters=3, warmup=1)
            pb = time_ms(torch, lambda: tce.fused_linear_cross_entropy_backward_plain(
                x, wr, shifted, lse_g, g_eff, tce._NEVER), iters=3, warmup=1)
            hit = (shifted >= 0) & (shifted < vl)
            local = torch.where(hit, shifted, torch.full_like(shifted, -100))
            leaves = [a.clone().requires_grad_() for a in (x, wr)]

            def comp():
                return F.cross_entropy(F.linear(leaves[0], leaves[1]), local,
                                       ignore_index=-100, reduction="none")
            cf = time_ms(torch, comp, iters=3, warmup=1)
            closs = comp()
            cb = time_ms(torch, lambda: torch.autograd.grad(
                closs, leaves, g_eff.to(closs.dtype), retain_graph=True),
                iters=3, warmup=1)
            del closs, leaves
            esz = x.element_size()
            flops = 2.0 * T * vl * H
            ins = (T * H + vl * H) * esz + T * 8
            b5 = bound(ins + 2 * T * 4, flops, dtype)
            b6 = bound(ins + 2 * T * 4 + T * H * esz, 2 * flops, dtype)
            b7 = bound(ins + 2 * T * 4 + vl * H * esz, 2 * flops, dtype)
            tag = f"TP shard [{T}, {H}, {vl}] {dtype}"
            print(f"  28d mp = {mp} {dtype}: each shard against its plain "
                  f"version: K5 loss/LSE err {e5:.3e}, K6 dx err {e6:.3e}, "
                  f"K7 dW err {e7:.3e} (tol {CE_LOSS_TOL} / {ptol} of the "
                  f"largest grad); combined: loss/LSE err {el:.3e}, dx err "
                  f"{edx:.3e}, dW err {edw:.3e} against the full vocab; "
                  f"rank 0's shard [{T}, {H}, {vl}]: K5 {k5:.3f} ms, K6 "
                  f"{k6:.3f} ms, K7 {k7:.3f} ms (bounds {b5[0]:.3f} / "
                  f"{b6[0]:.3f} / {b7[0]:.3f} ms, {b5[1]}); plain "
                  f"{pf:.3f} / {pb:.3f} ms; F.cross_entropy(F.linear) "
                  f"{cf:.3f} / {cb:.3f} ms")
            for name, line, ms, plain, lib, bd, err in (
                    ("fused_ce_forward", ":384", k5, pf, cf, b5, e5),
                    ("fused_ce_bwd_dx", ":446", k6, pb, cb, b6, e6),
                    ("fused_ce_bwd_dw", ":446", k7, pb, cb, b7, e7)):
                row = {"name": name, "route": "cuda", "dtype": dtype,
                       "shape": tag, "mp": mp,
                       "source": "paddle_tpu_torch/csrc/fused_ce.cu",
                       "replaces": "paddle_tpu/ops/fused_ce.py" + line,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain,
                       "bound_ms": bd[0], "bound_by": bd[1],
                       "library_ms": lib}
                if mp == 2:     # launches: 28b's, filled in by phase_dist
                    rows.append(row)
                else:           # no main path runs mp = 4
                    print("  28d not on the main path, so not in the kernels "
                          "line: " + json.dumps(row))
            del parts
        del x, w, labels, gg, loss, lse, dx, dw
        torch.cuda.empty_cache()
    return rows


def ulysses_rows(torch, attn):
    """The kernels line's rows of K1-K3 on the Ulysses route's shape
    (phase 28c: 6 of 12 heads at the full sequence, causal, f32), each
    held against its plain version here."""
    g = torch.Generator(device="cuda").manual_seed(29)
    shape = (SP_SHAPE[0], SP_SHAPE[1] // 2) + SP_SHAPE[2:]
    q, k, v, do, lse, delta, scale = bwd_case(torch, attn, shape, True,
                                              "float32", g)
    args = (q, k, v, lse, do, delta, scale, True)
    dq = attn.flash_bwd_dq(*args)
    dk, dv = attn.flash_bwd_dkv(*args)
    rq, rk, rv = attn.flash_attention_backward_plain(*args)
    key = (shape, True, "float32")
    errs = {key + ("dq",): float((dq - rq).abs().max()),
            key + ("dk",): float((dk - rk).abs().max()),
            key + ("dv",): float((dv - rv).abs().max())}
    for name, got, want in (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv)):
        err = errs[key + (name,)]
        check(err <= 1e-4 * float(want.abs().max()),
              f"28c Ulysses shape K2/K3 {name}: err {err}")
    del q, k, v, do, lse, delta, dq, dk, dv, rq, rk, rv
    return flash_rows(torch, attn, shape, True, "float32", errs, g)


def phase_lint(torch, amp, optimizer, TransformerLMConfig, GPTForCausalLM):
    """28e: the captured flagship step (tied GPT-124M, O1 bf16, AdamW,
    through jit.to_static) and the paged engine's decode lint clean; a
    planted f64 upcast on the card is flagged."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.analysis import lint
    from paddle_tpu_torch.serving import ServingEngine
    model = dist_gpt(torch, TransformerLMConfig, GPTForCausalLM)
    opt = optimizer.AdamW(1e-4, parameters=model.named_parameters(),
                          weight_decay=0.01)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, model.cfg.vocab_size, (DIST["batch"], DIST["seq"])).astype(
            np.int64)).cuda()

    @jit.to_static(lint=True)
    def step(ids, labels):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model(ids, labels=labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    forms = []
    for _ in range(4):
        step(ids, ids)
        forms.append(step.last_form)
    check(forms == ["warmup", "record", "capture", "replay"],
          f"28e: forms {forms}")
    program = next(iter(step.entries.values()))["record"].program
    found = step.lint()
    check(program.cuda and found == [],
          "28e: the captured flagship step lints with "
          + "; ".join(map(str, found)))
    del step, model, opt
    cfg = TransformerLMConfig(dropout=0.0)
    served = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).eval()
    eng = ServingEngine(served)
    r = eng.add_request(np.arange(1, 65), max_new_tokens=4)
    eng.run()
    check(r.done, "28e: the engine did not finish its request")
    found_eng = eng.lint()
    check(found_eng == [], "28e: the engine's decode lints with "
          + "; ".join(map(str, found_eng)))
    planted = lint.lint_fn(lambda x: (x.double() * 2).float().sum(),
                           torch.ones(1024, device="cuda"))
    check([f.pass_name for f in planted] == ["f64-upcast"]
          and planted[0].severity == "error",
          f"28e: the planted upcast gave {planted}")
    print(f"  28e lint: the captured flagship step ({len(program.ops)} ops "
          f"recorded, forms {forms}) clean; the paged engine's decode "
          f"clean; a planted f64 upcast flagged at {planted[0].site}")
    eng.close()
    del eng, served
    torch.cuda.empty_cache()


def phase_dist(torch, amp, optimizer, attn, tce, TransformerLMConfig,
               GPTForCausalLM):
    """Phase 28: 28a-28e; returns the kernels line's rows (the TP shard
    rows of K5-K7 with 28b's launches, the Ulysses rows of K1-K3 with
    28c's)."""
    t0 = time.perf_counter()
    phase_dist_world1(torch, TransformerLMConfig, GPTForCausalLM)
    f32, bf16, uly, one, tpgen = phase_dist_ranks(
        torch, amp, optimizer, TransformerLMConfig, GPTForCausalLM, attn)
    rows = phase_tp_shards(torch, tce)
    for row in rows:
        i = {"fused_ce_forward": 3, "fused_ce_bwd_dx": 4,
             "fused_ce_bwd_dw": 5}[row["name"]]
        row["launches"] = (f32 if row["dtype"] == "float32" else bf16)[i]
    urows = ulysses_rows(torch, attn)
    for row, n in zip(urows, uly):
        row["launches"] = n
        row["shape"] = "Ulysses " + row["shape"]
    # 28f's rows: K1 at a rank's share of the heads, K4 at its engine's
    # decode shape
    k1_shape = tuple(tpgen[0]["k1_shape"])
    trow = k1_inference_row(torch, attn, k1_shape, label="28f")
    trow["shape"] = "28f TP rank forward " + str(list(k1_shape))
    trow["launches"] = sum(t["k1"] for t in tpgen)
    from paddle_tpu_torch.ops import paged_attention
    krow = k4_row_at(torch, paged_attention, TPGEN["slots"],
                     [TPGEN["prompt_len"] + TPGEN["new"]] * TPGEN["slots"],
                     "28f TP rank decode")
    krow["launches"] = sum(t["k4"] for t in tpgen)
    phase_lint(torch, amp, optimizer, TransformerLMConfig, GPTForCausalLM)
    print(f"  phase 28 in {time.perf_counter() - t0:.1f} s")
    return rows + urows + [trow, krow], one


# Phase 29: the rest of the distributed layer on two rank processes that
# share the card over gloo, started by the port's launcher
# (distributed.launch_mod.spawn): 29a GPT-124M in two pipeline stages
# (pp = 2, 4 microbatches of [2, 1024], 1F1B), 29b ZeRO-2 (os_g,
# sharding = 2, each rank half of the batch), both 3 f32 AdamW steps of
# phase 28b's batch, held to 28b's one-process run (its losses within
# TP_LOSS_RTOL, each gathered leaf by tp_leaves_check). 29a's stages each
# hold the parameters they run and no others (PP_HELD_SHARE at most of the
# model: the tied embedding sits on both ends); 29b's ranks hold the grads
# of their partition only after the backward (ZERO_STATE_SHARE at most of
# the model's), and their peak device memory over the steps is printed
# beside one process's on the same [4, 1024] batch; 29b's ranks save
# their train state (incubate.checkpoint) and one process loads it, each
# tensor torch.equal to the ranks'; 29c the MoE layer at ep = 2 (MOE
# shape) against one process's, within MOE_TOL of each tensor's largest
# element (the combine summed over the ranks in another order), and one
# GradientMerge and one DGCMomentum step against their plain steps. A
# rank's launches are counted from the wrappers' counters. The state on
# disk goes under a temporary directory.
MOE = dict(d_model=768, hidden=3072, experts=8, top_k=2, tokens=8192)
MOE_TOL = 1e-4
ZERO_STATE_SHARE = 0.6
# a stage's parameters over the model's: 6 of 12 blocks and the 38.6M tied
# embedding (its copy on each end) come to about 0.66 at pp = 2
PP_HELD_SHARE = 0.7
PP_DIST = dict(acc=4)


def _zero_opt_state(inner, model):
    """{parameter name_kind: tensor} of an optimizer's state."""
    names = {id(p): n for n, p in model.named_parameters()}
    return {f"{names[pid]}_{kind}": t
            for kind, store in inner._accumulators.items()
            for pid, t in store.items()}


def phase29_rank(outdir, queue):
    """One rank of phase 29 (the launcher set its PADDLE_* variables)."""
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    try:
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        sys.path.insert(0, HERE)
        queue.put((rank, _phase29_rank(torch, outdir)))
    except BaseException:  # noqa: BLE001 - the parent raises it
        import traceback
        queue.put((rank, {"error": traceback.format_exc()[-3000:]}))
        raise


def _phase29_rank(torch, outdir):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import (collective, fleet,
                                              init_parallel_env, sharding,
                                              topology)
    from paddle_tpu_torch.incubate import moe
    from paddle_tpu_torch.incubate.checkpoint import sharded
    from paddle_tpu_torch.ops import attention as attn
    from paddle_tpu_torch.ops import fused_ce as tce
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              TransformerLMConfig)
    env = init_parallel_env(timeout=300)
    out = {"backend": collective._default_group().backend,
           "rank": env.rank}
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv, tce.fused_ce_forward, tce.fused_ce_bwd_dx,
                tce.fused_ce_bwd_dw)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 50304, (DIST["batch"], DIST["seq"])).astype(np.int64)).cuda()

    def strategy(**degrees):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = degrees
        s.pipeline_configs = {"accumulate_steps": PP_DIST["acc"]}
        s.sharding_configs = {"stage": 2}
        return s

    # 29a: two pipeline stages
    fleet.init(is_collective=True, strategy=strategy(pp_degree=2))
    model = fleet.distributed_model(dist_gpt(torch, TransformerLMConfig,
                                             GPTForCausalLM))
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        DIST["lr"], parameters=model._layers.named_parameters(),
        weight_decay=0.01))
    collective.host_staged_bytes.clear()
    torch.cuda.synchronize()
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    losses = [float(model.train_batch((ids, ids), opt))
              for _ in range(DIST["steps"])]
    torch.cuda.synchronize()
    out["pp_s"] = time.perf_counter() - t0
    out["pp_launches"] = [fn.launches for fn in wrappers]
    out["pp_losses"] = losses
    out["pp_blocks"] = model.stage_blocks
    out["pp_staged_bytes"] = dict(collective.host_staged_bytes)
    wemb = model._layers.gpt.word_embeddings.weight.detach().clone()
    other = wemb.clone()
    collective.broadcast(other, src=1, group=model._pp)
    out["pp_tied_equal"] = bool(torch.equal(wemb, other))
    leaves = [p for p in model._layers.parameters()]
    out["pp_held_bytes"] = sum(p.untyped_storage().nbytes() for p in leaves)
    out["pp_runs_bytes"] = sum(p.numel() * p.element_size()
                               for p in model._local)
    out["pp_model_bytes"] = sum(p.numel() * p.element_size() for p in leaves)
    state = {k: v.cpu() for k, v in model.full_state_dict().items()}
    if env.rank == 0:
        torch.save(state, os.path.join(outdir, "pp_state.pt"))
    del model, opt, state, wemb, other
    torch.cuda.empty_cache()
    # 29b: ZeRO-2 over the two ranks, each half the batch
    topology.reset()
    fleet.init(is_collective=True, strategy=strategy(sharding_degree=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    m = dist_gpt(torch, TransformerLMConfig, GPTForCausalLM)
    model = fleet.distributed_model(m)
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        DIST["lr"], parameters=m.named_parameters(), weight_decay=0.01))
    per = DIST["batch"] // 2
    mine = ids[env.rank * per:(env.rank + 1) * per]
    torch.cuda.synchronize()
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    losses = []
    for _ in range(DIST["steps"]):
        loss = model(mine, labels=mine)
        loss.backward()
        if "zero_grad_bytes" not in out:
            out["zero_grad_bytes"] = sum(
                p.grad.numel() * p.grad.element_size()
                for p in m.parameters() if p.grad is not None)
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    torch.cuda.synchronize()
    out["zero_s"] = time.perf_counter() - t0
    out["zero_peak"] = torch.cuda.max_memory_allocated() - base
    out["zero_launches"] = [fn.launches for fn in wrappers]
    out["zero_losses"] = losses
    out["zero_state_bytes"] = sharding.state_bytes(opt)
    out["zero_sizes"] = opt._zero.sizes
    path = os.path.join(outdir, "zero_ckpt")
    t0 = time.perf_counter()
    sharded.save_sharded_train_state(dict(m.named_parameters()), opt, path)
    out["zero_save_s"] = time.perf_counter() - t0
    state = _zero_opt_state(opt._inner_opt, m)
    torch.save({k: v.cpu() for k, v in state.items()},
               os.path.join(outdir, f"zero_opt{env.rank}.pt"))
    if env.rank == 0:
        torch.save({k: v.detach().cpu() for k, v in m.named_parameters()},
                   os.path.join(outdir, "zero_state.pt"))
    del model, opt, m, state
    torch.cuda.empty_cache()
    # 29c: the MoE layer at ep = 2
    topology.reset()
    fleet.init(is_collective=True, strategy=strategy(mp_degree=2))
    layer = moe.MoELayer(MOE["d_model"], MOE["hidden"], MOE["experts"],
                         top_k=MOE["top_k"],
                         generator=torch.Generator().manual_seed(29))
    x, cot = moe_inputs(torch)
    x = x.cuda().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = layer(x)
    ((y * cot.cuda()).sum() + layer.aux_loss).backward()
    torch.cuda.synchronize()
    out["moe_s"] = time.perf_counter() - t0
    got = {"y": y.detach().cpu(), "aux": layer.aux_loss.detach().cpu(),
           "dx": x.grad.cpu(), "dgate": layer.gate.grad.cpu()}
    for k in ("w1", "b1", "w2", "b2"):
        got["d" + k] = getattr(layer, k).grad.cpu()
    torch.save(got, os.path.join(outdir, f"moe_rank{env.rank}.pt"))
    out["moe_local_experts"] = layer.local_experts
    out["staged"] = dict(collective.host_staged)
    import torch.distributed as dist
    dist.destroy_process_group()
    return out


def moe_inputs(torch):
    g = torch.Generator().manual_seed(291)
    return (torch.randn(MOE["tokens"], MOE["d_model"], generator=g),
            torch.randn(MOE["tokens"], MOE["d_model"], generator=g) * 1e-3)


def spawn29(outdir, timeout=DIST["timeout"]):
    """Phase 29's two ranks through the port's launcher; their results by
    rank. Every process is joined or killed."""
    import multiprocessing as mp
    from paddle_tpu_torch.distributed import launch_mod
    queue = mp.get_context("spawn").Queue()
    ctx = launch_mod.spawn(phase29_rank, args=(outdir, queue), nprocs=2,
                           join=False)
    results = {}
    deadline = time.time() + timeout
    try:
        while len(results) < 2:
            left = deadline - time.time()
            check(left > 0, f"29: ranks {sorted({0, 1} - set(results))} "
                  f"gave no result in {timeout} s")
            try:
                rank, res = queue.get(timeout=min(left, 10))
            except Exception:  # noqa: BLE001 - queue.Empty: poll again
                dead = [p.exitcode for p in ctx.processes
                        if p.exitcode not in (None, 0)]
                check(not dead, f"29: a rank exited {dead} without a result")
                continue
            results[rank] = res
    finally:
        for p in ctx.processes:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    for r, res in results.items():
        check("error" not in res, f"29: rank {r} failed:\n{res.get('error')}")
    return [results[r] for r in range(2)]


def phase29_one(torch, optimizer, TransformerLMConfig, GPTForCausalLM,
                outdir):
    """29b's checkpoint loaded by one process (a world of one, no process
    group): every parameter and every state tensor torch.equal to what
    the ranks held (their own saves beside the checkpoint)."""
    from paddle_tpu_torch.incubate.checkpoint import sharded
    model = dist_gpt(torch, TransformerLMConfig, GPTForCausalLM)
    opt = optimizer.AdamW(DIST["lr"], parameters=model.named_parameters(),
                          weight_decay=0.01)
    t0 = time.perf_counter()
    sharded.load_sharded_train_state(os.path.join(outdir, "zero_ckpt"),
                                     dict(model.named_parameters()), opt)
    load_s = time.perf_counter() - t0
    got = _zero_opt_state(opt, model)
    want = {}
    for r in range(2):
        want.update(torch.load(os.path.join(outdir, f"zero_opt{r}.pt")))
    check(set(got) == set(want), f"29b: the loaded state's keys differ: "
          f"{sorted(set(got) ^ set(want))[:6]}")
    bad = [k for k, v in want.items() if not torch.equal(got[k].cpu(), v)]
    check(not bad, f"29b: loaded state differs from the ranks': {bad[:6]}")
    params = torch.load(os.path.join(outdir, "zero_state.pt"))
    pbad = [k for k, p in model.named_parameters()
            if not torch.equal(p.detach().cpu(), params[k])]
    check(not pbad, f"29b: loaded parameters differ: {pbad[:6]}")
    print(f"  29b one process loaded the ranks' train state ({len(got)} "
          f"optimizer tensors, {len(params)} parameters) in {load_s:.2f} s: "
          f"each torch.equal to the ranks'")
    del model, opt, got, want, params
    torch.cuda.empty_cache()


def phase29_one_peak(torch, optimizer, TransformerLMConfig, GPTForCausalLM):
    """One process's peak device memory over 29b's steps on one rank's
    batch ([4, 1024], the whole state unpartitioned), as 29b's ranks
    measure theirs: from before the model is built."""
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, 50304, (DIST["batch"], DIST["seq"])).astype(np.int64)).cuda()
    mine = ids[:DIST["batch"] // 2]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = dist_gpt(torch, TransformerLMConfig, GPTForCausalLM)
    opt = optimizer.AdamW(DIST["lr"], parameters=model.named_parameters(),
                          weight_decay=0.01)
    for _ in range(DIST["steps"]):
        loss = model(mine, labels=mine)
        loss.backward()
        opt.step()
        opt.clear_grad()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del model, opt, loss, ids, mine
    torch.cuda.empty_cache()
    return peak


def phase29_moe(torch, outdir, optimizer):
    """29c: the two ranks' MoE layer against one process's on the same
    weights and tokens; then one GradientMerge (k = 2) and one
    DGCMomentum step on the one-process layer against their plain
    steps."""
    from paddle_tpu_torch.distributed.fleet import meta_optimizers as meta
    from paddle_tpu_torch.incubate import moe
    layer = moe.MoELayer(MOE["d_model"], MOE["hidden"], MOE["experts"],
                         top_k=MOE["top_k"],
                         generator=torch.Generator().manual_seed(29))
    x, cot = moe_inputs(torch)
    x = x.cuda().requires_grad_()
    y = layer(x)
    ((y * cot.cuda()).sum() + layer.aux_loss).backward()
    want = {"y": y.detach(), "aux": layer.aux_loss.detach(), "dx": x.grad,
            "dgate": layer.gate.grad}
    for k in ("w1", "b1", "w2", "b2"):
        want["d" + k] = getattr(layer, k).grad
    ranks = [torch.load(os.path.join(outdir, f"moe_rank{r}.pt"))
             for r in range(2)]
    errs = []
    el = MOE["experts"] // 2
    for name, w in want.items():
        top = float(w.abs().max())
        err = 0.0
        for r, got in enumerate(ranks):
            ref = w[r * el:(r + 1) * el] if name in ("dw1", "db1", "dw2",
                                                     "db2") else w
            err = max(err, float((got[name].cuda() - ref).abs().max()))
        check(err <= MOE_TOL * max(top, 1e-30), f"29c {name}: err {err} > "
              f"{MOE_TOL} x {top}")
        errs.append(f"{name} {err:.3e}")
    cap = int(max(1, 1.25 * MOE["tokens"] * MOE["top_k"] / MOE["experts"]))
    print(f"  29c MoE ep = 2 ({MOE['experts']} experts, top-{MOE['top_k']}, "
          f"{MOE['tokens']} tokens, d {MOE['d_model']}, hidden "
          f"{MOE['hidden']}, capacity {cap}, f32) against one process: "
          f"{', '.join(errs)} (tol {MOE_TOL} of each largest)")
    # one GradientMerge step (k = 2: the mean of two steps' grads)
    ps = [layer.w1, layer.gate]
    g1 = [p.grad.clone() for p in ps]
    g2 = [torch.randn_like(p) * 1e-3 for p in ps]
    before = [p.detach().clone() for p in ps]
    gm = meta.GradientMergeOptimizer(optimizer.SGD(
        0.1, parameters=ps), k_steps=2)
    for grads in (g1, g2):
        for p, g in zip(ps, grads):
            p.grad = g.clone()
        gm.step()
    gm_err = max(float((p - (b - 0.1 * (a + c) / 2)).abs().max())
                 for p, b, a, c in zip(ps, before, g1, g2))
    check(gm_err <= 1e-6, f"29c GradientMerge: err {gm_err}")
    # one DGCMomentum step at sparsity 0.999 against its plain formula
    w = layer.w2
    g = w.grad.clone()
    w0 = w.detach().clone()
    dgc = meta.DGCMomentumOptimizer(0.1, momentum=0.9, parameters=[w],
                                    sparsity=[0.999])
    dgc.step()
    thr = torch.topk(g.abs().reshape(-1),
                     max(1, int(g.numel() * 0.001))).values[-1]
    plain = w0 - 0.1 * g * (g.abs() >= thr).float()
    dgc_err = float((w.detach() - plain).abs().max())
    kept = int((w.detach() != w0).sum())
    check(dgc_err == 0.0, f"29c DGCMomentum: err {dgc_err}")
    print(f"  29c GradientMerge (k = 2) step against the plain SGD step on "
          f"the mean grad: err {gm_err:.3e}; DGCMomentum at sparsity 0.999 "
          f"against its plain top-k step: err {dgc_err:.3e}, "
          f"{kept} of {w.numel()} elements moved")
    del layer, x, y, want, ranks
    torch.cuda.empty_cache()


def ce_rows(torch, tce, t, h, v, dtype, label, g):
    """The kernels line's K5-K7 rows at [t, h, v] in ``dtype`` (29: a
    pipeline stage's or a ZeRO rank's f32 head; 31c: GPT-3 1.3B's bf16
    one), each held against its plain version (bf16 grads against d
    kept f32 and against d rounded to bf16 as the kernels round it, the
    row's error the latter's) and timed with its bound and
    F.cross_entropy(F.linear)."""
    import torch.nn.functional as F
    x, w, labels, gg = ce_case(torch, t, h, v, dtype, g)
    loss, lse = tce.fused_ce_forward(x, w, labels)
    dx = tce.fused_ce_bwd_dx(x, w, labels, lse, gg)
    dw = tce.fused_ce_bwd_dw(x, w, labels, lse, gg)
    xf, wf = x.float(), w.float()
    rloss, rlse = tce.fused_linear_cross_entropy_plain(xf, wf, labels)
    e5 = max(float((loss - rloss).abs().max()),
             float((lse - rlse).abs().max()))
    check(e5 <= CE_LOSS_TOL, f"{label} K5 [{t}, {h}, {v}] {dtype}: err {e5}")
    del rloss, rlse
    variants = ([(None, CE_F32_TOL)] if dtype == "float32" else
                [(None, CE_BF16_TOL), (torch.bfloat16, CE_BF16D_TOL)])
    for d_dtype, tol in variants:
        rdx, rdw = tce.fused_linear_cross_entropy_backward_plain(
            xf, wf, labels, lse, gg, d_dtype=d_dtype)
        e6 = float((dx.float() - rdx).abs().max())
        e7 = float((dw.float() - rdw).abs().max())
        check(bool(torch.isfinite(dx).all() and torch.isfinite(dw).all())
              and e6 <= tol * float(rdx.abs().max())
              and e7 <= tol * float(rdw.abs().max()),
              f"{label} K6/K7 [{t}, {h}, {v}] {dtype} (d "
              f"{d_dtype or 'f32'}): err {e6} / {e7}")
        del rdx, rdw
    del xf, wf
    k5 = time_ms(torch, lambda: tce.fused_ce_forward(x, w, labels), iters=5,
                 warmup=1)
    k6 = time_ms(torch, lambda: tce.fused_ce_bwd_dx(x, w, labels, lse, gg),
                 iters=5, warmup=1)
    k7 = time_ms(torch, lambda: tce.fused_ce_bwd_dw(x, w, labels, lse, gg),
                 iters=5, warmup=1)
    pf = time_ms(torch, lambda: tce.fused_linear_cross_entropy_plain(
        x, w, labels), iters=3, warmup=1)
    pb = time_ms(torch, lambda: tce.fused_linear_cross_entropy_backward_plain(
        x, w, labels, lse, gg), iters=3, warmup=1)
    leaves = [a.clone().requires_grad_() for a in (x, w)]

    def comp():
        return F.cross_entropy(F.linear(leaves[0], leaves[1]), labels,
                               ignore_index=-100, reduction="none")
    cf = time_ms(torch, comp, iters=3, warmup=1)
    closs = comp()
    cb = time_ms(torch, lambda: torch.autograd.grad(
        closs, leaves, gg, retain_graph=True), iters=3, warmup=1)
    del closs, leaves
    flops = 2.0 * t * v * h
    esz = 4 if dtype == "float32" else 2
    ins = (t * h + v * h) * esz + t * 8
    b5 = bound(ins + 2 * t * 4, flops, dtype)
    b6 = bound(ins + 2 * t * 4 + t * h * esz, 2 * flops, dtype)
    b7 = bound(ins + 2 * t * 4 + v * h * esz, 2 * flops, dtype)
    tag = f"{label} [{t}, {h}, {v}] {dtype}"
    print(f"  {tag}: K5 {k5:.3f} ms, K6 {k6:.3f} ms, K7 {k7:.3f} ms "
          f"(bounds {b5[0]:.3f} / {b6[0]:.3f} / {b7[0]:.3f} ms); plain "
          f"{pf:.3f} / {pb:.3f} ms; F.cross_entropy(F.linear) {cf:.3f} / "
          f"{cb:.3f} ms; errs {e5:.3e} / {e6:.3e} / {e7:.3e}")
    rows = []
    for name, line, ms, plain, lib, bd, err in (
            ("fused_ce_forward", ":93", k5, pf, cf, b5, e5),
            ("fused_ce_bwd_dx", ":183", k6, pb, cb, b6, e6),
            ("fused_ce_bwd_dw", ":198", k7, pb, cb, b7, e7)):
        rows.append({"name": name, "route": "cuda", "dtype": dtype,
                     "shape": tag,
                     "source": "paddle_tpu_torch/csrc/fused_ce.cu",
                     "replaces": "paddle_tpu/ops/fused_ce.py" + line,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain,
                     "bound_ms": bd[0], "bound_by": bd[1],
                     "library_ms": lib})
    del x, w, labels, gg, loss, lse, dx, dw
    torch.cuda.empty_cache()
    return rows


def phase_dist_rest(torch, optimizer, attn, tce, TransformerLMConfig,
                    GPTForCausalLM, one):
    """Phase 29 (above); ``one`` is 28b's one-process f32 run. Returns the
    kernels line's rows: K1-K3 at a stage's microbatch and at a ZeRO
    rank's batch, K5-K7 at the last stage's microbatch and at a ZeRO
    rank's batch, with the ranks' launches."""
    import tempfile
    t0 = time.perf_counter()
    L = 12
    steps, acc = DIST["steps"], PP_DIST["acc"]
    with tempfile.TemporaryDirectory() as outdir:
        ranks = spawn29(outdir)
        spawn_s = time.perf_counter() - t0
        check(all(r["backend"] == "gloo" for r in ranks),
              f"29: backends {[r['backend'] for r in ranks]}")
        # 29a
        a, b = (r["pp_losses"] for r in ranks)
        check(a == b, f"29a: the stages' losses differ: {a} {b}")
        rel = max(abs(x - y) / abs(y) for x, y in zip(a, one["losses"]))
        check(rel <= TP_LOSS_RTOL, f"29a: losses {a} against one process's "
              f"{one['losses']}: {rel} > {TP_LOSS_RTOL}")
        blocks = [r["pp_blocks"] for r in ranks]
        check(blocks == [list(range(6)), list(range(6, 12))],
              f"29a: stage blocks {blocks}")
        for s, r in enumerate(ranks):
            want = [steps * acc * 6] * 3 + [steps * acc * s] * 3
            check(r["pp_launches"] == want, f"29a stage {s}: launches "
                  f"{r['pp_launches']}, not {want}")
        check(all(r["pp_tied_equal"] for r in ranks),
              "29a: the two copies of the tied embedding differ")
        held = [r["pp_held_bytes"] / r["pp_model_bytes"] for r in ranks]
        check(all(r["pp_held_bytes"] == r["pp_runs_bytes"] for r in ranks)
              and max(held) <= PP_HELD_SHARE,
              f"29a: parameter bytes a stage "
              f"{[r['pp_held_bytes'] for r in ranks]}, of what it runs "
              f"{[r['pp_runs_bytes'] for r in ranks]}, shares {held}")
        pp = torch.load(os.path.join(outdir, "pp_state.pt"))
        tp_leaves_check(torch, "29a pp = 2", pp, one["final"], one["init"])
        del pp
        print(f"  29a GPT-124M pp = 2 ({acc} microbatches of [2, 1024], "
              f"1F1B) f32 AdamW: losses {a} on both stages, one process "
              f"{one['losses']}, largest relative difference {rel:.3e} (tol "
              f"{TP_LOSS_RTOL}); the tied embedding's two copies bit-equal; "
              f"3 steps {ranks[0]['pp_s']:.2f} s; launches K1/K2/K3/K5/K6/K7 "
              f"stage 0 {ranks[0]['pp_launches']}, stage 1 "
              f"{ranks[1]['pp_launches']}; bytes staged through pinned "
              f"memory, stage 0 {ranks[0]['pp_staged_bytes']}, stage 1 "
              f"{ranks[1]['pp_staged_bytes']}; parameter bytes a stage "
              f"{[r['pp_held_bytes'] for r in ranks]} of the model's "
              f"{ranks[0]['pp_model_bytes']} "
              f"({[round(x, 4) for x in held]}, tol {PP_HELD_SHARE})")
        # 29b
        mean = [(x + y) / 2 for x, y in zip(*(r["zero_losses"]
                                              for r in ranks))]
        rel = max(abs(x - y) / abs(y) for x, y in zip(mean, one["losses"]))
        check(rel <= TP_LOSS_RTOL, f"29b: mean losses {mean} against one "
              f"process's {one['losses']}: {rel} > {TP_LOSS_RTOL}")
        for r in ranks:
            want = [steps * L] * 3 + [steps] * 3
            check(r["zero_launches"] == want, f"29b: launches "
                  f"{r['zero_launches']}, not {want}")
        whole = sum(2 * v.numel() * 4 + 8 for v in one["final"].values())
        shares = [r["zero_state_bytes"] / whole for r in ranks]
        check(max(shares) <= ZERO_STATE_SHARE and
              sum(r["zero_state_bytes"] for r in ranks) == whole,
              f"29b: optimizer state shares {shares}")
        model_bytes = sum(v.numel() * 4 for v in one["final"].values())
        gshares = [r["zero_grad_bytes"] / model_bytes for r in ranks]
        check(max(gshares) <= ZERO_STATE_SHARE,
              f"29b: grads held after the backward, shares {gshares}")
        zs = torch.load(os.path.join(outdir, "zero_state.pt"))
        tp_leaves_check(torch, "29b ZeRO os_g", zs, one["final"],
                        one["init"])
        del zs
        one_peak = phase29_one_peak(torch, optimizer, TransformerLMConfig,
                                    GPTForCausalLM)
        print(f"  29b GPT-124M ZeRO os_g sharding = 2 (each rank [4, 1024]) "
              f"f32 AdamW: mean of the ranks' losses {mean}, one process "
              f"{one['losses']}, largest relative difference {rel:.3e}; "
              f"partition sizes {ranks[0]['zero_sizes']} elements (the tied "
              f"embedding's 38.6M on rank 0); optimizer state a rank "
              f"{[r['zero_state_bytes'] for r in ranks]} bytes, "
              f"{[round(x, 4) for x in shares]} of one process's {whole} "
              f"(tol {ZERO_STATE_SHARE}); 3 steps {ranks[0]['zero_s']:.2f} "
              f"s; save_sharded_train_state {ranks[0]['zero_save_s']:.2f} "
              f"s; launches a rank {ranks[0]['zero_launches']}; grads "
              f"held after the backward "
              f"{[r['zero_grad_bytes'] for r in ranks]} bytes "
              f"({[round(x, 4) for x in gshares]} of the model's); "
              f"peak device memory over the steps a rank "
              f"{[r['zero_peak'] for r in ranks]} bytes, one process on the "
              f"same [4, 1024] batch {one_peak} bytes")
        phase29_one(torch, optimizer, TransformerLMConfig, GPTForCausalLM,
                    outdir)
        # 29c
        check([r["moe_local_experts"] for r in ranks] == [4, 4],
              "29c: not 4 experts a rank")
        phase29_moe(torch, outdir, optimizer)
        print(f"  29 host-staged collectives, rank 0: {ranks[0]['staged']}; "
              f"the spawn {spawn_s:.1f} s; MoE step on the ranks "
              f"{ranks[0]['moe_s']:.2f} s")
    g = torch.Generator(device="cuda").manual_seed(2929)
    rows = []
    for shape, label, counts, key in (
            ((2, 12, 1024, 64), "29a stage", 3, "pp_launches"),
            ((4, 12, 1024, 64), "29b rank", 3, "zero_launches")):
        errs = {}
        q, k, v, do, lse, delta, scale = bwd_case(torch, attn, shape, True,
                                                  "float32", g)
        args = (q, k, v, lse, do, delta, scale, True)
        for name, got, want in zip(
                ("dq", "dk", "dv"),
                (attn.flash_bwd_dq(*args), *attn.flash_bwd_dkv(*args)),
                attn.flash_attention_backward_plain(*args)):
            err = float((got - want).abs().max())
            check(err <= 1e-4 * float(want.abs().max()),
                  f"29 K2/K3 {shape} {name}: err {err}")
            errs[(shape, True, "float32", name)] = err
        del q, k, v, do, lse, delta
        frows = flash_rows(torch, attn, shape, True, "float32", errs, g)
        for row, n in zip(frows, (sum(r[key][i] for r in ranks)
                                  for i in range(3))):
            row["launches"] = n
            row["shape"] = f"{label} {row['shape']}"
        rows += frows
    for t, label, key in ((2048, "29a last stage", "pp_launches"),
                          (4096, "29b rank", "zero_launches")):
        crows = ce_rows(torch, tce, t, 768, 50304, "float32", label, g)
        for row, i in zip(crows, (3, 4, 5)):
            row["launches"] = sum(r[key][i] for r in ranks)
        rows += crows
    print(f"  phase 29 in {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------- phase 30
# The fluid compat layer on the card (paddle_tpu_torch/fluid/): 30a the
# fluid-1.x ResNet-50 image-classification program (PaddlePaddle/models
# PaddleCV/image_classification/models/resnet.py, ResNet50) built with
# fluid.layers and trained through fluid.Executor(fluid.CUDAPlace(0))
# against the same fluid code eager under fluid.dygraph.guard(); 30b the
# PTB language model of PaddleNLP's language_model "small" config with
# StaticRNN; 30c fluid control flow on the card; 30d the port's torch
# GPT-124M through fluid.io and a Predictor (jit.save's torch.export
# path: the attention one custom-op node, K1), and onnx.export of it;
# 30e the legacy collective fleet on one rank.
# PaddleCV's piecewise learning rates (0.1, 0.01, 0.001) are for batch
# 256; at batch 32 the linear scaling rule makes them 1/8 (at 0.1 the
# repeated batch sends the loss from 7.6 to 32, and a 1e-6 difference
# between two runs' second losses grows to 0.34 by the fifth)
FLUID = dict(batch=32, size=224, classes=1000, steps=10,
             depth=(3, 4, 6, 3), filters=(64, 128, 256, 512),
             bounds=(10000, 20000), values=(0.0125, 0.00125, 0.000125),
             decay=1e-4)
PTB = dict(vocab=10000, hidden=200, layers=2, steps=20, batch=20,
           init_scale=0.1, lr=1.0, clip=5.0, train_steps=10, cpu_steps=3)
# the batch-norm moving statistics after 30a's 10 steps, program against
# eager, relative to each buffer's largest
FLUID_STAT_TOL = 1e-4
FLUID_RUNS = 6       # Predictor runs a batch size in 30d
LEGACY_STEPS = 3     # 30e's minimize steps


def fluid_resnet50(fluid, img, label, prefix):
    """ResNet50 of PaddleCV image_classification/models/resnet.py in
    fluid.layers: conv2d without bias then batch_norm(act), bottlenecks
    [3, 4, 6, 3] with 1x1/3x3/1x1 convs and a projection where the shape
    changes, global average pool2d, fc to 1000 classes;
    softmax_with_cross_entropy + mean, top-1 and top-5 accuracy. Every
    parameter-making call is named, so the same code run eagerly reuses
    the program's layers."""
    L = fluid.layers

    def conv_bn(x, nf, k, stride=1, act=None, name=None):
        c = L.conv2d(x, nf, k, stride=stride, padding=(k - 1) // 2,
                     bias_attr=False, name=name)
        return L.batch_norm(c, act=act, name="bn_" + name)

    conv = conv_bn(img, 64, 7, 2, "relu", prefix + "conv1")
    conv = L.pool2d(conv, pool_size=3, pool_type="max", pool_stride=2,
                    pool_padding=1)
    for block, (n, nf) in enumerate(zip(FLUID["depth"], FLUID["filters"])):
        for i in range(n):
            stride = 2 if i == 0 and block != 0 else 1
            nm = f"{prefix}res{block + 2}{chr(97 + i)}"
            c0 = conv_bn(conv, nf, 1, act="relu", name=nm + "_branch2a")
            c1 = conv_bn(c0, nf, 3, stride, "relu", nm + "_branch2b")
            c2 = conv_bn(c1, nf * 4, 1, name=nm + "_branch2c")
            short = conv
            if int(conv.shape[1]) != nf * 4 or stride != 1:
                short = conv_bn(conv, nf * 4, 1, stride,
                                name=nm + "_branch1")
            conv = L.elementwise_add(short, c2, act="relu")
    pool = L.pool2d(conv, pool_type="avg", global_pooling=True)
    logits = L.fc(pool, FLUID["classes"], name=prefix + "fc")
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    prob = L.softmax(logits)
    return loss, L.accuracy(prob, label, k=1), L.accuracy(prob, label, k=5)


def fluid_lr(paddle):
    """30a's learning rate: fluid.layers.piecewise_decay at the global
    step (0 here)."""
    lr = paddle.fluid.layers.piecewise_decay(list(FLUID["bounds"]),
                                             list(FLUID["values"]))
    return float(lr.numpy())


def fluid_program(paddle, prefix):
    fluid = paddle.fluid
    paddle.enable_static()
    try:
        main = fluid.Program()
        with fluid.program_guard(main):
            img = fluid.data("img", [FLUID["batch"], 3, FLUID["size"],
                                     FLUID["size"]], "float32")
            label = fluid.data("label", [FLUID["batch"], 1], "int64")
            fetch = fluid_resnet50(fluid, img, label, prefix)
            fluid.optimizer.Momentum(
                fluid_lr(paddle), momentum=0.9,
                weight_decay=fluid.regularizer.L2Decay(FLUID["decay"])
            ).minimize(fetch[0])
    finally:
        paddle.disable_static()
    return main, list(fetch)


def fluid_feed(seed):
    rs = np.random.RandomState(seed)
    b, s = FLUID["batch"], FLUID["size"]
    return {"img": rs.randn(b, 3, s, s).astype(np.float32),
            "label": rs.randint(0, FLUID["classes"], (b, 1)).astype(
                np.int64)}


def fluid_stats_err(a, b):
    """The largest difference of the moving statistics between two
    layer-cache states, relative to each buffer's largest value."""
    worst = 0.0
    for key, arrays in a.items():
        for name in ("_mean", "_variance"):
            if name in arrays:
                top = max(float(np.abs(arrays[name]).max()), 1e-30)
                worst = max(worst, float(np.abs(
                    arrays[name] - b[key][name]).max()) / top)
    return worst


def fluid_resnet_phase(torch, paddle):
    """30a: the program's 10 steps, the eager twin's, the persistables
    round trip, step ms, idle share and peak."""
    from paddle_tpu_torch.fluid import convert
    fluid = paddle.fluid
    L = fluid.layers
    paddle.set_device("gpu")
    L.clear_layer_cache()
    t0 = time.perf_counter()
    main, fetch = fluid_program(paddle, "a_")
    build_s = time.perf_counter() - t0
    init = convert.layer_cache_state(L._layer_cache)
    n_params = sum(a.size for arrays in init.values()
                   for k, a in arrays.items()
                   if not k.startswith("_"))
    feed = fluid_feed(30)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    losses, accs, times = [], [], []
    # both runs under torch's deterministic algorithms: cuDNN's default
    # weight-grad algorithms part two runs at about 1e-6 by step 2, which
    # ResNet-50 on a repeated batch grows to percents by step 5
    with static_deterministic(torch, "30a program"):
        for _ in range(FLUID["steps"]):
            t1 = time.perf_counter()
            loss, top1, top5 = exe.run(main, feed=feed, fetch_list=fetch)
            times.append((time.perf_counter() - t1) * 1e3)
            losses.append(float(loss))
            accs.append((float(top1), float(top5)))
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"30a: losses {losses}")
    trained = convert.layer_cache_state(L._layer_cache)
    step_ms = float(np.median(times[3:]))
    graphs = [g for fn in exe._cache.values() if hasattr(fn, "graphs")
              for g in fn.graphs()]
    check(len(graphs) == 1, f"30a: {len(graphs)} graphs for one feed "
          "signature")
    print(f"  30a fluid ResNet-50 program ({len(main.ops)} records, "
          f"{len(init)} layers, {n_params} parameters, built in "
          f"{build_s:.2f} s) at [{FLUID['batch']}, 3, {FLUID['size']}, "
          f"{FLUID['size']}] f32 through fluid.Executor(CUDAPlace(0)), "
          f"torch's deterministic algorithms: "
          f"losses {[round(x, 6) for x in losses]}, top-1/top-5 of the "
          f"last {accs[-1]}; step ms {[round(t, 1) for t in times]} "
          f"(median of steps 4-{FLUID['steps']} {step_ms:.2f}, "
          f"{FLUID['batch'] / step_ms * 1e3:.1f} images/s), one graph, "
          f"peak {peak / 2**30:.3f} GiB over {held / 2**30:.3f} held")
    # the eager twin: the same fluid code under dygraph.guard, the
    # program's layers (their name= keys) back at their initial values
    convert.load_layer_cache(init)
    params = []
    for layer in L._layer_cache.values():
        params += list(layer.parameters())
    opt = paddle.optimizer.Momentum(
        fluid_lr(paddle), momentum=0.9, parameters=params,
        weight_decay=fluid.regularizer.L2Decay(FLUID["decay"]))
    img = paddle.to_tensor(feed["img"])
    label = paddle.to_tensor(feed["label"])
    eager, e_times = [], []
    with fluid.dygraph.guard(fluid.CUDAPlace(0)), \
            static_deterministic(torch, "30a eager"):
        for _ in range(FLUID["steps"]):
            t1 = time.perf_counter()
            loss = fluid_resnet50(fluid, img, label, "a_")[0]
            loss.backward()
            opt.step()
            opt.clear_grad()
            eager.append(float(loss.numpy()))
            e_times.append((time.perf_counter() - t1) * 1e3)
    rel = max(abs(a - b) / max(abs(b), 1e-12)
              for a, b in zip(losses, eager))
    check(rel <= LOSS_RTOL, f"30a: program losses {losses} against eager "
          f"{eager}: {rel} > {LOSS_RTOL}")
    stats = fluid_stats_err(trained, convert.layer_cache_state(
        L._layer_cache))
    check(stats <= FLUID_STAT_TOL, f"30a: moving statistics {stats} > "
          f"{FLUID_STAT_TOL}")
    print(f"    eager under dygraph.guard from the same weights: losses "
          f"{[round(x, 6) for x in eager]}, largest relative difference "
          f"{rel:.3e} (tol {LOSS_RTOL}); the 53 batch norms' moving "
          f"statistics within {stats:.3e} of each largest (tol "
          f"{FLUID_STAT_TOL}); eager step ms "
          f"{[round(t, 1) for t in e_times]}")
    # persistables: the trained program saved, loaded into a fresh one
    convert.load_layer_cache(trained)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        fluid.io.save_persistables(exe, d, main)
        kept = dict(L._layer_cache)
        L.clear_layer_cache()
        fresh, fresh_fetch = fluid_program(paddle, "a_")
        fluid.io.load_persistables(exe, d, fresh)
        L._layer_cache.clear()
        L._layer_cache.update(kept)
    nxt = fluid_feed(31)
    a = exe.run(main, feed=nxt, fetch_list=fetch[:1])[0]
    b = fluid.Executor(fluid.CUDAPlace(0)).run(fresh, feed=nxt,
                                               fetch_list=fresh_fetch[:1])[0]
    check(np.array_equal(a, b), f"30a: the next loss {float(a)} against "
          f"the loaded program's {float(b)}")
    idle = static_idle(torch, lambda: exe.run(main, feed=nxt,
                                              fetch_list=fetch[:1]), ())
    print(f"    save_persistables -> load_persistables into a fresh "
          f"program: the next loss {float(a):.6f}, bit for bit; the "
          f"program's idle share over 3 replays "
          + ("not measured (no device time)" if idle is None
             else f"{idle:.4f}"))
    del main, fresh, exe, opt, params, kept
    L.clear_layer_cache()
    return step_ms


def ptb_program(paddle, prefix, lr):
    """PaddleNLP language_model "small": 2 LSTM layers of 200 in a
    StaticRNN over 20 steps (the cell in fluid ops: fc over [x, h], four
    gates split), the 10000-word softmax, the loss summed over steps and
    averaged over the batch, SGD(1.0) with ClipGradByGlobalNorm(5.0);
    every parameter uniform in +-0.1."""
    fluid = paddle.fluid
    L = fluid.layers
    F = paddle.nn.functional
    V, H, T, B = PTB["vocab"], PTB["hidden"], PTB["steps"], PTB["batch"]

    def attr():
        return fluid.ParamAttr(initializer=paddle.nn.initializer.Uniform(
            -PTB["init_scale"], PTB["init_scale"]))
    paddle.enable_static()
    try:
        main = fluid.Program()
        with fluid.program_guard(main):
            x = fluid.data("x", [T, B], "int64")
            y = fluid.data("y", [T * B, 1], "int64")
            emb = L.embedding(x, [V, H], param_attr=attr(),
                              name=prefix + "emb")
            rnn = L.StaticRNN()
            with rnn.step():
                inp = rnn.step_input(emb)
                for layer in range(PTB["layers"]):
                    h_prev = rnn.memory(shape=[B, H], batch_ref=inp)
                    c_prev = rnn.memory(shape=[B, H], batch_ref=inp)
                    gates = L.fc(L.concat([inp, h_prev], axis=1), 4 * H,
                                 param_attr=attr(), bias_attr=attr(),
                                 name=f"{prefix}lstm{layer}")
                    i, j, f, o = L.split(gates, 4, dim=1)
                    c = c_prev * F.sigmoid(f) \
                        + F.sigmoid(i) * paddle.tanh(j)
                    h = paddle.tanh(c) * F.sigmoid(o)
                    rnn.update_memory(h_prev, h)
                    rnn.update_memory(c_prev, c)
                    inp = h
                rnn.step_output(inp)
            out = L.reshape(rnn(), [T * B, H])
            logits = L.fc(out, V, param_attr=attr(), bias_attr=attr(),
                          name=prefix + "softmax")
            loss = L.scale(L.reduce_sum(
                L.softmax_with_cross_entropy(logits, y)), 1.0 / B)
            paddle.optimizer.SGD(
                lr, grad_clip=paddle.nn.ClipGradByGlobalNorm(PTB["clip"])
            ).minimize(loss)
    finally:
        paddle.disable_static()
    return main, loss


def ptb_feeds(n):
    rs = np.random.RandomState(301)
    out = []
    for _ in range(n):
        seq = rs.randint(0, PTB["vocab"], (PTB["steps"] + 1, PTB["batch"]))
        out.append({"x": seq[:-1].astype(np.int64),
                    "y": seq[1:].reshape(-1, 1).astype(np.int64)})
    return out


def fluid_ptb_phase(torch, paddle):
    """30b: 10 Executor.run steps on the card (a ScanRecord forward and
    backward), the first 3 against the same program on the CPU from the
    same weights."""
    from paddle_tpu_torch.fluid import convert
    fluid = paddle.fluid
    L = fluid.layers
    feeds = ptb_feeds(PTB["train_steps"])
    paddle.set_device("gpu")
    L.clear_layer_cache()
    main, loss = ptb_program(paddle, "p_", PTB["lr"])
    init = convert.layer_cache_state(L._layer_cache)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    losses, times = [], []
    for f in feeds:
        t1 = time.perf_counter()
        losses.append(float(exe.run(main, feed=f, fetch_list=[loss])[0]))
        times.append((time.perf_counter() - t1) * 1e3)
    check(all(np.isfinite(losses)), f"30b: losses {losses}")
    kinds = sorted({type(r).__name__ for r in main.ops})
    paddle.set_device("cpu")
    L.clear_layer_cache()
    cpu_main, cpu_loss = ptb_program(paddle, "p_", PTB["lr"])
    convert.load_layer_cache(init)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu = [float(cpu_exe.run(cpu_main, feed=f, fetch_list=[cpu_loss])[0])
           for f in feeds[:PTB["cpu_steps"]]]
    paddle.set_device("gpu")
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(losses, cpu))
    check(rel <= LOSS_RTOL, f"30b: card losses {losses[:3]} against the "
          f"CPU's {cpu}: {rel} > {LOSS_RTOL}")
    step_ms = float(np.median(times[3:]))
    tokens = PTB["steps"] * PTB["batch"]
    print(f"  30b PTB LM (PaddleNLP language_model small: vocab "
          f"{PTB['vocab']}, hidden {PTB['hidden']}, {PTB['layers']} LSTM "
          f"layers, {PTB['steps']} steps, batch {PTB['batch']}) with "
          f"StaticRNN ({kinds}): losses {[round(x, 5) for x in losses]}; "
          f"the first {PTB['cpu_steps']} against the CPU program's "
          f"{[round(x, 5) for x in cpu]}, largest relative difference "
          f"{rel:.3e} (tol {LOSS_RTOL}); step ms "
          f"{[round(t, 1) for t in times]} (median of steps 4-10 "
          f"{step_ms:.2f}, {tokens / step_ms * 1e3:.0f} tokens/s)")
    L.clear_layer_cache()
    del main, cpu_main, exe, cpu_exe
    return step_ms


def fluid_while_programs(paddle):
    """30c's While programs: the counter loop over a fed vector, the
    fed bound, and assign's copy inside the body."""
    fluid = paddle.fluid
    L = fluid.layers
    progs = {}
    paddle.enable_static()
    try:
        main = fluid.Program()
        with fluid.program_guard(main):
            x = fluid.data("x", [4], "float32")
            n = fluid.data("n", [1], "int64")
            i = L.fill_constant([1], "int64", 0)
            acc = L.fill_constant([4], "float32", 0.0)
            snap = L.fill_constant([1], "int64", -1)
            cond = L.less_than(i, n)
            w = L.While(cond)
            with w.block():
                L.assign(acc * 0.5 + x, output=acc)
                copy = L.assign(i)
                L.assign(copy, output=snap)
                i = L.increment(i, in_place=True)
                L.less_than(i, n, cond=cond)
            out = acc * 1.0
        progs["while"] = (main, [out, snap])
    finally:
        paddle.disable_static()
    return progs


def fluid_control_phase(torch, paddle):
    """30c: While programs under Executor.run on the card (one graph, a
    conditional while node, the trip count from the feed) against the
    CPU's; cond, case, switch_case and the tensor arrays under
    jit.to_static (they have no program record in either package: the
    reference's programs hold While and StaticRNN records only)."""
    from paddle_tpu_torch.core import graph_cond
    fluid = paddle.fluid
    L = fluid.layers
    made = []          # the conditional nodes the captures make, by kind
    real_node = graph_cond.node

    def counting_node(flag, kind, *a, **k):
        made.append(kind)
        return real_node(flag, kind, *a, **k)
    graph_cond.node = counting_node
    try:
        _fluid_control(torch, paddle, fluid, L, made)
    finally:
        graph_cond.node = real_node


def _fluid_control(torch, paddle, fluid, L, made):
    results = []
    for device, place in (("gpu", fluid.CUDAPlace(0)),
                          ("cpu", fluid.CPUPlace())):
        paddle.set_device(device)
        main, fetch = fluid_while_programs(paddle)["while"]
        exe = fluid.Executor(place)
        got = []
        for n in (3, 7, 2, 9, 5, 1):
            x = np.arange(4, dtype=np.float32) + n
            got.append(exe.run(main, feed={"x": x, "n": np.array(
                [n], np.int64)}, fetch_list=fetch))
        results.append((got, exe))
    paddle.set_device("gpu")
    (card, exe), (cpu, _) = results
    for a, b in zip(card, cpu):
        for u, v in zip(a, b):
            check(np.allclose(u, v, rtol=1e-6, atol=0), f"30c While: card "
                  f"{u} against CPU {v}")
    graphs = [g for fn in exe._cache.values()
              for g in getattr(fn, "graphs", list)()]
    whiles = made.count("while")
    check(len(graphs) == 1 and whiles == 1, f"30c: While programs made "
          f"{len(graphs)} graphs and {whiles} while nodes for one feed "
          "signature")
    snaps = [int(r[1][0]) for r in card]
    check(snaps == [n - 1 for n in (3, 7, 2, 9, 5, 1)],
          f"30c: assign's snapshots {snaps}")

    def branches(x, k):
        y = L.cond(x.sum() > 0, lambda: x * 2.0, lambda: x - 1.0)
        z = L.case([(k == 0, lambda: y + 1.0), (k == 1, lambda: y * 3.0)],
                   default=lambda: y)
        w = L.switch_case(k, {0: lambda: z * 0.5, 1: lambda: z - 2.0},
                          default=lambda: z)
        arr = L.create_array("float32")
        L.array_write(w, 0, arr)
        L.array_write(y, 1, arr)
        # (array_length is a host count made into a tensor: a copy from
        # the host, which a capture refuses; it stays outside the step)
        return L.array_read(arr, 0) + L.array_read(arr, 1)

    f = paddle.jit.to_static(branches)
    before = len(made)
    cases = [(s, k) for s in (1.0, -1.0) for k in (0, 1, 2)] * 2
    for s, k in cases:
        x = np.linspace(-1, 2, 6).astype(np.float32) * s
        kk = np.array([k], np.int64)
        got = f(paddle.to_tensor(x), paddle.to_tensor(kk)).numpy()
        paddle.set_device("cpu")
        want = branches(paddle.to_tensor(x), paddle.to_tensor(kk)).numpy()
        paddle.set_device("gpu")
        check(np.array_equal(got, want), f"30c branches ({s}, {k}): card "
              f"{got} against CPU {want}")
    n_graphs = len(f.graphs())
    ifs = made[before:].count("if")
    check(n_graphs == 1 and ifs > 0, f"30c: the branches made {n_graphs} "
          f"graphs, {ifs} if nodes")
    print(f"  30c fluid control flow on the card: While programs under "
          f"Executor.run for bounds (3, 7, 2, 9, 5, 1) = the CPU's, one "
          f"graph with {whiles} while node, assign's copy the "
          f"pre-increment counter; cond, case, switch_case and the tensor "
          f"arrays under jit.to_static over {len(cases)} calls = eager on "
          f"the CPU, one graph with {ifs} if nodes")


def fluid_deploy_phase(torch, attn, cfg):
    """30d: phase 7's untied f32 GPT-124M through fluid.io (jit.save's
    torch.export path) and a Predictor at batches 1 and 8, K1 = 12 a run;
    onnx.export of the module. Returns the Predictor's K1 launches by
    batch and the two K1 rows of the exported node."""
    import collections
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.jit.save_load import export_module
    from paddle_tpu_torch.onnx_proto import onnx_pb2
    from paddle_tpu_torch.static import InputSpec
    from paddle_tpu_torch.text.models import GPTForCausalLM
    L, S, V = cfg.num_layers, cfg.max_seq_len, cfg.vocab_size
    hd = cfg.hidden_size // cfg.num_heads
    op = torch.ops.paddle_tpu_torch.flash_attention_forward
    rows = [k1_inference_row(torch, attn, (b, cfg.num_heads, S, hd),
                             fn=op, label="30d")
            for b in (1, 8)]
    for row in rows:
        row["name"] = "flash_attention_forward (torch.export node)"
    paddle.set_device("gpu")
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).eval()
    spec = [InputSpec([None, S], "int64")]
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "gpt")
        t0 = time.perf_counter()
        paddle.fluid.io.save_inference_model(path, model=model,
                                             input_spec=spec)
        save_s = time.perf_counter() - t0
        check(os.path.getsize(path + ".pdmodel") < (64 << 20),
              f"30d: the .pdmodel is {os.path.getsize(path + '.pdmodel')} "
              "B: it holds the values")
        ep = export_module(model, spec)
        nodes = [str(n.target) for n in ep.graph.nodes
                 if n.op == "call_function"]
        k1_nodes = sum("flash_attention_forward" in t for t in nodes)
        check(k1_nodes == L and not any(
            "softmax" in t or "scaled_dot_product" in t for t in nodes),
            f"30d: the exported graph's attention: {k1_nodes} K1 nodes")
        del ep
        loaded = paddle.fluid.io.load_inference_model(path)
        ids1 = np.random.RandomState(301).randint(0, V, (1, S))
        with torch.no_grad():
            want1 = model(torch.from_numpy(ids1).cuda()).cpu().numpy()
        same_or_close(loaded(paddle.to_tensor(ids1)).numpy(), want1,
                      DEPLOY_TOL, "30d load_inference_model")
        del loaded
        pred = inference.create_predictor(inference.Config(path))
        print(f"  30d torch GPT-124M (phase 7's untied f32 weights) through "
              f"fluid.io.save_inference_model in {save_s:.2f} s "
              f"(torch.export: {len(nodes)} nodes, {k1_nodes} of them the "
              f"K1 operator, no softmax or SDPA; .pdmodel "
              f"{os.path.getsize(path + '.pdmodel')} B, .pdiparams "
              f"{os.path.getsize(path + '.pdiparams')} B)")
        for b in (1, 8):
            ids = np.random.RandomState(300 + b).randint(0, V, (b, S))
            with torch.no_grad():
                want = model(torch.from_numpy(ids).cuda()).cpu().numpy()
            outs, times, k1s = predictor_runs(torch, pred, ids, FLUID_RUNS,
                                              attn)
            check(k1s == [L] * FLUID_RUNS, f"30d batch {b}: K1 {k1s}")
            launches[b] = sum(k1s)
            diffs = [same_or_close(o, want, DEPLOY_TOL, f"30d batch {b}")
                     for o in outs]
            x = paddle.to_tensor(ids)
            dev = device_ms(torch, lambda: pred.layer(x))
            print(f"    batch {b}: run ms {[round(t, 2) for t in times]} "
                  f"(host to host, median of replays "
                  f"{float(np.median(times[3:])):.2f}), device {dev:.3f} ms "
                  f"a replay; K1 {k1s}; against eager: "
                  + ("the same bits every run" if all(d[1] for d in diffs)
                     else f"max abs diff {max(d[0] for d in diffs):.3e}"))
        check(len(pred.layer.graphs()) == 2, "30d: not one graph a batch")
        del pred
        t0 = time.perf_counter()
        onnx_path = paddle.onnx.export(model, os.path.join(d, "gpt"),
                                       input_spec=spec)
        onnx_s = time.perf_counter() - t0
        proto = onnx_pb2.ModelProto()
        with open(onnx_path, "rb") as f:
            proto.ParseFromString(f.read())
        sd = model.state_dict()
        checked = 0
        for t in proto.graph.initializer:
            if t.name not in sd:
                continue
            card = sd[t.name].detach()
            if card.dim() == 2 and "embeddings" not in t.name:
                card = card.t()
            arr = np.frombuffer(t.raw_data, np.float32).reshape(list(t.dims))
            check(np.array_equal(arr, card.contiguous().cpu().numpy()),
                  f"30d onnx initializer {t.name} is not the card's bits")
            checked += 1
        kinds = collections.Counter(n.op_type for n in proto.graph.node)
        check(kinds["Softmax"] == L, f"30d onnx: {kinds['Softmax']} Softmax")
        print(f"    onnx.export from the card in {onnx_s:.1f} s "
              f"({os.path.getsize(onnx_path)} B): re-parsed, {checked} "
              f"initializers = the card's bits (a linear weight as "
              f"[in, out]); nodes {dict(sorted(kinds.items()))}")
    del model
    torch.cuda.empty_cache()
    return launches, rows


def fluid_legacy_phase(torch, attn, cfg):
    """30e: the legacy collective fleet on one rank: distributed_optimizer
    (AdamW) and 3 minimize steps of phase 7's GPT-124M at 8 x 1024 against
    a plain AdamW's, bit for bit; the (K1, K2, K3) launches of the legacy
    steps."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.fluid.incubate.fleet.base import role_maker
    from paddle_tpu_torch.fluid.incubate.fleet.collective import fleet
    from paddle_tpu_torch.text.models import GPTForCausalLM
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (8, cfg.max_seq_len)).astype(np.int64)).cuda()
    runs = []
    for legacy in (False, True):
        model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
            1234)).train()
        opt = paddle.optimizer.AdamW(1e-4, parameters=model.named_parameters(),
                                     weight_decay=0.01)
        step = None
        if legacy:
            os.environ.setdefault("PADDLE_TRAINER_ID", "0")
            fleet.init(role_maker.PaddleCloudRoleMaker(is_collective=True))
            step = fleet.distributed_optimizer(opt)
        for w in wrappers:
            w.launches = 0
        losses = []
        for _ in range(LEGACY_STEPS):
            loss = model(ids, labels=ids)
            if legacy:
                step.minimize(loss)
            else:
                loss.backward()
                opt.step()
            opt.clear_grad()
            losses.append(loss.item())
        torch.cuda.synchronize()
        runs.append((losses, [w.launches for w in wrappers],
                     {n: p.detach().clone()
                      for n, p in model.named_parameters()}))
        del model, opt, step, loss
    (plain, pl_k, pw), (legacy, lg_k, lw) = runs
    same = plain == legacy and all(torch.equal(pw[n], lw[n]) for n in pw)
    check(same, f"30e: legacy fleet losses {legacy} against plain AdamW "
          f"{plain}, weights the same bits: {same}")
    want = [LEGACY_STEPS * cfg.num_layers] * 3
    check(lg_k == want and pl_k == want, f"30e: launches {lg_k} {pl_k}")
    print(f"  30e legacy collective fleet (fluid.incubate.fleet.collective, "
          f"PaddleCloudRoleMaker(is_collective=True), worker "
          f"{fleet.worker_index()} of {fleet.worker_num()}): "
          f"{LEGACY_STEPS} minimize steps of GPT-124M at 8 x "
          f"{cfg.max_seq_len} = plain AdamW's losses {legacy} and every "
          f"weight, bit for bit; K1/K2/K3 {lg_k}")
    del runs, pw, lw
    torch.cuda.empty_cache()
    return tuple(lg_k)


def phase_fluid(torch, attn, cfg):
    """Phase 30: 30a-30e. Returns 30d's Predictor K1 launches by batch and
    its two K1 rows, and 30e's (K1, K2, K3) launches."""
    import paddle_tpu_torch as paddle
    t0 = time.perf_counter()
    try:
        fluid_resnet_phase(torch, paddle)
        lazy_release(torch)
        fluid_ptb_phase(torch, paddle)
        fluid_control_phase(torch, paddle)
        lazy_release(torch)
        launches, rows = fluid_deploy_phase(torch, attn, cfg)
        legacy = fluid_legacy_phase(torch, attn, cfg)
    finally:
        from paddle_tpu_torch.core import device as device_mod
        device_mod._current_place = None
    for row, b in zip(rows, (1, 8)):
        row["launches"] = launches[b]
    print(f"  phase 30 in {time.perf_counter() - t0:.1f} s")
    return rows, legacy


# ---------------------------------------------------------------- phase 31

# 31a: GPT-3 1.3B (the reference's BASELINE config 5, text.models
# .gpt3_1p3b: 24 layers, hidden 2048, 16 heads of 128) at batch 4 x 1024
# under amp O1 bf16, pruned 2:4 by ASP, AdamW inside LookAhead inside
# ASP's decorate, ModelAverage over the parameters; 31b decodes from the
# average
INCUBATE = dict(batch=4, seq=1024, steps=10, lr=1e-4, alpha=0.5, k=5,
                prompts=4, prompt_len=16, new=32)
# the tensors held to LookAhead's formula at the k-th steps (pruned and
# not), and the weights whose card masks are held to numpy's
INCUBATE_WATCH = ("gpt.blocks.0.attn.qkv.weight",
                  "gpt.blocks.23.mlp.fc2.weight",
                  "gpt.blocks.11.attn.qkv.bias", "gpt.ln_f.weight")
INCUBATE_HOST_MASKS = ("gpt.blocks.0.attn.qkv.weight",
                       "gpt.position_embeddings.weight")
# 31d: TrainEpochRange over GPT-124M cut to 2 blocks, f32, 2 steps an
# epoch, 3 epochs
CKPT = dict(layers=2, batch=2, epochs=3, steps=2, lr=1e-4)
SOFTMAX_SHAPE = (4, 16, 1024, 1024)
# bf16 softmax outputs (below 1) against the f32 composition of the
# bf16 inputs: half an ulp of a value below 1 is at most 2e-3
SOFTMAX_TOL = 1e-2
HOST_OP = r"""
#include <cstdint>
extern "C" void scaled_sum(const float** ins, const int64_t* sizes,
                           int n_in, float* out, int64_t out_size) {
  for (int64_t i = 0; i < out_size; ++i) {
    float acc = 0;
    for (int j = 0; j < n_in; ++j) acc += ins[j][i];
    out[i] = acc * 2.0f;
  }
}
"""


def reference_view(name, p):
    """A parameter of the port's torch GPT in the reference's layout
    (linear weights transposed), as ASP's masks are laid out."""
    from paddle_tpu_torch.text.convert import is_transposed
    return p.t() if is_transposed(name, p.dim()) else p


def incubate_train(torch, attn, tce, amp, optimizer):
    """31a (and 31e's card masks against numpy's). Returns the model
    holding ModelAverage's average, and the K1, K2, K3, K5, K6, K7
    launches of the 10 steps."""
    from paddle_tpu_torch import incubate
    from paddle_tpu_torch.incubate import asp
    from paddle_tpu_torch.text.models import gpt3_1p3b
    steps, k, alpha = INCUBATE["steps"], INCUBATE["k"], INCUBATE["alpha"]
    t0 = time.perf_counter()
    model = gpt3_1p3b(dropout=0.0, generator=torch.Generator().manual_seed(
        1234)).train()
    L = model.cfg.num_layers
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    host = {n: reference_view(n, params[n]).detach().cpu().numpy()
            for n in INCUBATE_HOST_MASKS}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    masks = asp.prune_model(model)
    torch.cuda.synchronize()
    prune_s = time.perf_counter() - t0
    check(sorted(masks) == sorted(n for n, p in params.items()
                                  if p.dim() == 2),
          f"31a: pruned {len(masks)} weights, not every 2-D parameter")
    for n, w in host.items():
        want = asp.get_mask_1d_plain(w, 2, 4) > 0
        got = reference_view(n, masks[n]).cpu().numpy()
        check(np.array_equal(got, want),
              f"31e: {n}'s mask on the card is not numpy's")
    del host
    dense = sum(int(m.sum()) for m in masks.values())
    print(f"  31a: gpt3_1p3b {n_params:,} parameters ({L} layers, hidden "
          f"{model.cfg.hidden_size}, {model.cfg.num_heads} heads of "
          f"{model.cfg.hidden_size // model.cfg.num_heads}), made in "
          f"{init_s:.1f} s; prune_model 2:4 over {len(masks)} weights in "
          f"{prune_s:.2f} s, {dense:,} kept; 31e: "
          + ", ".join(INCUBATE_HOST_MASKS) + "'s card masks = numpy's")
    inner = optimizer.AdamW(INCUBATE["lr"],
                            parameters=model.named_parameters(),
                            weight_decay=0.01)
    la = incubate.LookAhead(inner, alpha=alpha, k=k)
    opt = asp.decorate(la)
    ma = incubate.ModelAverage(0.15, parameters=model.parameters())
    order = list(params)
    watch = {n: params[n] for n in INCUBATE_WATCH}
    fast, sums = {}, {n: torch.zeros_like(p) for n, p in watch.items()}

    def watched_step(step=inner.step):
        # the weights after AdamW, before LookAhead and the masks
        step()
        if (la._step + 1) % k == 0:
            for n, p in watch.items():
                fast[n] = p.detach().clone()
    inner.step = watched_step
    ids = torch.from_numpy(np.random.RandomState(31).randint(
        0, model.cfg.vocab_size, (INCUBATE["batch"], INCUBATE["seq"])
    ).astype(np.int64)).cuda()
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv, tce.fused_ce_forward, tce.fused_ce_bwd_dx,
                tce.fused_ce_bwd_dw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers:
        fn.launches = 0
    losses, times, lookahead = [], [], []
    for step in range(1, steps + 1):
        slow = ({n: la._slow[order.index(n)].clone() for n in watch}
                if step % k == 0 else None)
        t0 = time.perf_counter()
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = model(ids, labels=ids)
        loss.backward()
        opt.step()
        ma.step()
        opt.clear_grad()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
        for n, m in masks.items():
            check(asp.check_mask_1d(reference_view(n, params[n]), 2, 4),
                  f"31a step {step}: {n} lost its 2:4 pattern")
        for n, p in watch.items():
            sums[n] += p
        if slow is not None:
            for n, p in watch.items():
                want = fast[n] - slow[n]
                want.mul_(alpha)
                want = slow[n] + want
                if n in masks:
                    want.mul_(masks[n])
                check(torch.equal(p, want), f"31a step {step}: {n} is not "
                      "LookAhead's mask * (slow + alpha (fast - slow))")
            lookahead.append(step)
    counts = tuple(fn.launches for fn in wrappers)
    peak = torch.cuda.max_memory_allocated()
    del inner.step
    check(all(np.isfinite(losses)), f"31a: non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"31a: loss did not fall: {losses}")
    want = (steps * L,) * 3 + (steps,) * 3
    check(counts == want, f"31a: K1/K2/K3/K5/K6/K7 launches {counts} != "
          f"{want}")
    before = {n: p.detach().clone() for n, p in params.items()}
    ma.apply()
    for n, p in watch.items():
        check(torch.equal(p, sums[n] / steps),
              f"31a: ModelAverage.apply(): {n} is not the sum / {steps}")
    ma.restore()
    check(all(torch.equal(p, before[n]) for n, p in params.items()),
          "31a: ModelAverage.restore() did not give the weights back")
    del before
    ma.apply(need_restore=False)
    step_ms = float(np.median(times[1:]))
    tokens = ids.numel()
    print(f"  31a: losses {[round(x, 6) for x in losses]}; step ms "
          f"{[round(t, 2) for t in times]}")
    print(f"  31a: median step (steps 2-{steps}) {step_ms:.2f} ms, "
          f"{tokens / step_ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB; K1/K2/K3 launches {counts[:3]}, K5/K6/K7 "
          f"{counts[3:]} ({steps} steps x {L} layers); 2:4 held on the card "
          f"after every step; LookAhead's formula at steps {lookahead} on "
          f"{len(watch)} tensors; ModelAverage.apply() = the sum / {steps} "
          f"and restore() the same bits")
    del opt, la, inner, ma, masks, sums, fast, loss
    model.eval()
    return model, counts


def incubate_generate(torch, attn, pa, model):
    """31b: greedy generate() from the averaged weights, the teacher-
    forced forward over its tokens (K1: f32 at head dim 128) and the
    engine's greedy streams (K4 at 16 heads of 128). Returns (K1
    launches, the forward's shape, K4 launches, the decode lengths)."""
    from paddle_tpu_torch.serving import ServingEngine
    L = model.cfg.num_layers
    b, p, new = INCUBATE["prompts"], INCUBATE["prompt_len"], INCUBATE["new"]
    prompts = np.random.RandomState(32).randint(
        0, model.cfg.vocab_size, (b, p)).astype(np.int64)
    ids = torch.from_numpy(prompts).cuda()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=new, temperature=0.0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(out.shape == (b, p + new) and torch.equal(out[:, :p], ids),
          f"31b: generate gave {tuple(out.shape)}")
    gen = out[:, p:].cpu().numpy()
    attn.flash_attention_forward.launches = 0
    with torch.inference_mode():
        lg = model(out[:, :-1])[:, p - 1:].float()
    k1 = attn.flash_attention_forward.launches
    check(k1 == L, f"31b: K1 launches {k1} != {L}")
    check(bool(torch.isfinite(lg).all()), "31b: non-finite logits")
    top2 = lg.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    pred = lg.argmax(-1).cpu().numpy()
    for r, i in np.argwhere(pred != gen):
        check(margin[r, i] < TIE_MARGIN, f"31b: row {r} token {i}: "
              f"{gen[r, i]} vs forward {pred[r, i]} at margin "
              f"{margin[r, i]:.3e}")
    eng = ServingEngine(model, num_slots=b, block_size=TPGEN["block"],
                        async_depth=1)
    pa.paged_decode_attention.launches = 0
    reqs = [eng.add_request(q, max_new_tokens=new) for q in prompts]
    eng.run()
    torch.cuda.synchronize()
    steps = eng.metrics.decode_steps
    k4 = pa.paged_decode_attention.launches
    check(k4 == steps * L, f"31b: K4 launches {k4} != decode steps {steps} "
          f"x {L}")
    same = 0
    for r, req in enumerate(reqs):
        check(len(req.generated) == new, f"31b: request {r} incomplete")
        i = first_divergence(req.generated, gen[r].tolist())
        if i is None:
            same += 1
            continue
        check(margin[r, i] < TIE_MARGIN, f"31b: engine row {r} token {i}: "
              f"{req.generated[i]} vs generate {gen[r, i]} at margin "
              f"{margin[r, i]:.3e}")
    print(f"  31b: generate() {b} x {new} greedy tokens in {gen_s:.2f} s "
          f"({b * new / gen_s:.1f} tokens/s); every token the teacher-forced "
          f"forward's argmax or a near-tie (< {TIE_MARGIN}; smallest top-2 "
          f"margin {margin.min():.3e}); K1 {k1}; the engine's streams "
          f"{same}/{b} equal to generate's, K4 {k4} = {steps} decode steps "
          f"x {L}")
    del eng, reqs
    return k1, (b, model.cfg.num_heads, p + new - 1,
                model.cfg.hidden_size // model.cfg.num_heads), k4, \
        [p + new - 1] * b


def incubate_rows(torch, attn, tce, pa, counts, k1_gen, k1_shape, k4,
                  lengths):
    """31c: the kernels at the new shapes against their plain versions,
    timed with bounds and library calls; the kernels line's rows with
    31a's and 31b's launches."""
    g = torch.Generator(device="cuda").manual_seed(31)
    shape = (INCUBATE["batch"], 16, INCUBATE["seq"], 128)
    errs = {}
    bwd_check(torch, attn, shape, True, "bfloat16", g, errs)
    rows = flash_rows(torch, attn, shape, True, "bfloat16", errs, g)
    rows += ce_rows(torch, tce, INCUBATE["batch"] * INCUBATE["seq"], 2048,
                    50304, "bfloat16", "31c GPT-3 1.3B head", g)
    for row, n in zip(rows, counts):
        row["launches"] = n
    for row in rows[:3]:
        row["shape"] = "31c GPT-3 1.3B " + row["shape"]
    krow = k4_row_at(torch, pa, len(lengths), lengths, "31b GPT-3 1.3B "
                     "decode", nh=16, hd=128)
    krow["launches"] = k4
    frow = k1_inference_row(torch, attn, k1_shape, label="31b")
    frow["shape"] = f"31b teacher-forced forward {list(k1_shape)}"
    frow["launches"] = k1_gen
    torch.cuda.empty_cache()
    return rows + [krow, frow]


def ckpt_train(torch, ac, stop_at=None, save_checkpoint=True):
    """31d's loop: GPT-124M cut to CKPT["layers"] blocks, f32, AdamW,
    CKPT["steps"] steps an epoch through a TrainEpochRange that holds the
    model and the optimizer, under torch's deterministic algorithms;
    stops at the start of epoch ``stop_at``. Returns (model, what
    ran)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                              TransformerLMConfig)
    cfg = TransformerLMConfig(dropout=0.0, num_layers=CKPT["layers"])
    model = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(
        1234)).train()
    opt = optimizer.AdamW(CKPT["lr"], parameters=model.named_parameters(),
                          weight_decay=0.01)
    r = ac.TrainEpochRange(CKPT["epochs"], "gpt124m",
                           save_checkpoint=save_checkpoint)
    r.add("model", model).add("opt", opt)
    out = {"start": r.restored_from, "epochs": [], "losses": []}
    with static_deterministic(torch, "31d"):
        for epoch in r.get():
            if epoch == stop_at:
                break
            for step in range(CKPT["steps"]):
                ids = torch.from_numpy(np.random.RandomState(
                    100 * epoch + step).randint(
                        0, cfg.vocab_size, (CKPT["batch"], cfg.max_seq_len)
                ).astype(np.int64)).cuda()
                loss = model(ids, labels=ids)
                loss.backward()
                opt.step()
                opt.clear_grad()
                out["losses"].append(loss.item())
            out["epochs"].append(epoch)
    return model, out


def ckpt_child(torch, stop_at, outdir):
    """A 31d child process: the loop until epoch ``stop_at`` (-1: to the
    end, then the final weights saved under ``outdir``); prints what ran
    as its last line."""
    from paddle_tpu_torch.incubate.checkpoint import auto_checkpoint as ac
    model, out = ckpt_train(torch, ac, stop_at)
    if stop_at < 0:
        torch.save(model.state_dict(), os.path.join(outdir, "final.pt"))
    print(json.dumps(out))
    return 0


def incubate_ckpt(torch):
    """31d: a child process runs 2 of 3 epochs and exits; a second child
    under the same job resumes at epoch 2 and finishes; their final loss
    and weights equal an uninterrupted child's, bit for bit."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="chip_smoke_31d_")
    try:
        def start(stop_at, job, outdir):
            os.makedirs(outdir, exist_ok=True)
            env = dict(os.environ, PADDLE_JOB_ID=job,
                       PADDLE_CHECKPOINT_DIR=os.path.join(root, "ckpt"),
                       CUBLAS_WORKSPACE_CONFIG=":4096:8")
            return subprocess.Popen(
                [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                 "--ckpt-child", str(stop_at), outdir], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        def result(proc, label):
            try:
                out, err = proc.communicate(timeout=300)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            check(proc.returncode == 0,
                  f"31d: the {label} child exited {proc.returncode}:\n"
                  f"{err[-3000:]}")
            lines = out.strip().splitlines()
            print("  31d " + label + ": " + " | ".join(
                ln.strip() for ln in lines[:-1] if "31d" in ln))
            return json.loads(lines[-1])

        t0 = time.perf_counter()
        whole_dir, resume_dir = (os.path.join(root, d)
                                 for d in ("whole", "resume"))
        procs = [start(-1, "31d_whole", whole_dir),
                 start(2, "31d_resume", resume_dir)]
        whole, first = (result(p, label)
                        for p, label in zip(procs, ("uninterrupted",
                                                    "first")))
        check(first["start"] == 0 and first["epochs"] == [0, 1],
              f"31d: the first child ran {first}")
        second = result(start(-1, "31d_resume", resume_dir), "second")
        check(second["start"] == 2 and second["epochs"] == [2],
              f"31d: the second child resumed at {second['start']} and ran "
              f"{second['epochs']}")
        check(whole["epochs"] == [0, 1, 2], f"31d: uninterrupted {whole}")
        check(first["losses"] + second["losses"] == whole["losses"],
              f"31d: losses {first['losses']} + {second['losses']} != "
              f"{whole['losses']}")
        a = torch.load(os.path.join(resume_dir, "final.pt"))
        b = torch.load(os.path.join(whole_dir, "final.pt"))
        check(a.keys() == b.keys() and all(torch.equal(a[n], b[n])
                                           for n in a),
              "31d: the resumed weights are not the uninterrupted run's")
        print(f"  31d: resumed at epoch 2 after 2 of 3 epochs; final loss "
              f"{second['losses'][-1]!r} = the uninterrupted run's, every "
              f"loss and all {len(a)} weights bit for bit; {CKPT['layers']} "
              f"blocks, {CKPT['steps']} f32 steps an epoch; "
              f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def incubate_small(torch):
    """31e: softmax_mask_fuse and its causal form at SOFTMAX_SHAPE bf16
    against the f32 composition; a host op on CUDA tensors against
    numpy; the CUDA generator state replaying paddle.rand."""
    import tempfile
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.utils import cpp_extension
    g = torch.Generator(device="cuda").manual_seed(35)
    x = (torch.randn(SOFTMAX_SHAPE, generator=g, device="cuda") * 3).to(
        torch.bfloat16)
    mask = torch.where(torch.rand(SOFTMAX_SHAPE[0], 1, *SOFTMAX_SHAPE[2:],
                                  generator=g, device="cuda") < 0.3,
                       -1e4, 0.0).to(torch.bfloat16)
    got = paddle.incubate.softmax_mask_fuse(paddle.Tensor(x),
                                            paddle.Tensor(mask))._value
    want = torch.softmax(x.float() + mask.float(), -1)
    e1 = (got.float() - want).abs().max().item()
    causal = torch.ones(SOFTMAX_SHAPE[-2:], dtype=torch.bool,
                        device="cuda").tril()
    got = paddle.incubate.softmax_mask_fuse_upper_triangle(
        paddle.Tensor(x))._value
    want = torch.softmax(torch.where(causal, x.float(), -1e9), -1)
    e2 = (got.float() - want).abs().max().item()
    check(got.dtype == torch.bfloat16 and e1 <= SOFTMAX_TOL
          and e2 <= SOFTMAX_TOL, f"31e: softmax_mask_fuse errs {e1} / {e2} "
          f"(tol {SOFTMAX_TOL})")
    del x, mask, got, want, causal
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "host_op.cc")
        with open(src, "w") as f:
            f.write(HOST_OP)
        mod = cpp_extension.load("chip_smoke_31e", [src],
                                 build_directory=d)
        a = torch.randn(1000, generator=g, device="cuda")
        b = torch.randn(1000, generator=g, device="cuda")
        out = mod.scaled_sum(paddle.Tensor(a), paddle.Tensor(b))._value
        want = (a.cpu().numpy() + b.cpu().numpy()) * 2
        check(out.device == a.device and np.array_equal(
            out.cpu().numpy(), want), "31e: the host op on CUDA tensors")
    paddle.seed(31)
    state = paddle.get_cuda_rng_state()
    draws = [paddle.rand([4096])._value.clone() for _ in range(2)]
    paddle.set_cuda_rng_state(state)
    again = [paddle.rand([4096])._value.clone() for _ in range(2)]
    check(all(torch.equal(u, v) for u, v in zip(draws, again))
          and not torch.equal(draws[0], draws[1]),
          "31e: set_cuda_rng_state(get_cuda_rng_state()) did not replay "
          "paddle.rand")
    print(f"  31e: softmax_mask_fuse / _upper_triangle at "
          f"{list(SOFTMAX_SHAPE)} bf16 within {e1:.3e} / {e2:.3e} of the f32 "
          f"composition (tol {SOFTMAX_TOL}); a g++ host op on CUDA tensors "
          f"= numpy, on their device; get/set_cuda_rng_state replays 2 "
          f"draws of paddle.rand")


def phase_incubate(torch, attn, tce, pa, amp, optimizer):
    """Phase 31; returns its kernels-line rows."""
    import gc
    t0 = time.perf_counter()
    model, counts = incubate_train(torch, attn, tce, amp, optimizer)
    gc.collect()
    torch.cuda.empty_cache()
    k1_gen, k1_shape, k4, lengths = incubate_generate(torch, attn, pa, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    rows = incubate_rows(torch, attn, tce, pa, counts, k1_gen, k1_shape, k4,
                         lengths)
    t2 = time.perf_counter()
    incubate_ckpt(torch)
    t3 = time.perf_counter()
    incubate_small(torch)
    print(f"  phase 31 in {time.perf_counter() - t0:.1f} s (31a-b "
          f"{t1 - t0:.1f}, 31c {t2 - t1:.1f}, 31d {t3 - t2:.1f}, 31e "
          f"{time.perf_counter() - t3:.1f})")
    return rows


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return card[0] if card else "nvidia-smi: no output"


def main():
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--parent", metavar="TREE",
                    help=f"a checkout of {PARENT}, whose fused_ce.cu (its "
                    "f32 K5) phases 9 and 11 compare with (default: git "
                    "history, where the checkout has it)")
    ap.add_argument("--fleet", action="store_true",
                    help="phases 1, 4, 16, 17 and 18 only (the build, "
                    "phase 4's streams, the hardened engine and the "
                    "router, the observatories and the fleet telemetry, "
                    "the fleet over replica processes); prints no "
                    "kernels line")
    ap.add_argument("--nn", action="store_true",
                    help="phases 1, 7 and 20 only (the build, the untied "
                    "GPT's training, and the same model written in the "
                    "Paddle nn surface); prints no kernels line")
    ap.add_argument("--bert", action="store_true",
                    help="phases 1 and 21 only (the build, BERT-base "
                    "pretraining and the Paddle surface's part B); prints "
                    "no kernels line")
    ap.add_argument("--vision", action="store_true",
                    help="phases 1 and 22 only (the build, the vision "
                    "surface and ResNet-50's config 2); prints no kernels "
                    "line")
    ap.add_argument("--static", action="store_true",
                    help="phases 1, 24 and 25 only (the build, jit.to_static: "
                    "the kernels inside a graph, configs 1-3 and the "
                    "flagship captured against eager, the rules; dy2static "
                    "and the static graph: Tensor control flow captured, "
                    "the flagship with a Tensor if, the surface GPT through "
                    "Executor.run); prints no kernels line")
    ap.add_argument("--deploy", action="store_true",
                    help="phases 1 and 26 only (the build, the surface "
                    "GPT-124M saved with jit.save and served by a Predictor "
                    "in f32 and int8, QAT, onnx.export); prints no kernels "
                    "line")
    ap.add_argument("--lazy", action="store_true",
                    help="phases 1 and 27 only (the build, the lazy eager "
                    "executor: the surface GPT-124M's plain eager loop "
                    "lazily against immediately, LeNet, the surface "
                    "BERT-base, the edge cases, _C_ops and the profiler); "
                    "prints no kernels line")
    ap.add_argument("--dist", action="store_true",
                    help="phases 1, 28 and 29 only (the build, the "
                    "distributed layer: a world of one over NCCL, the "
                    "two-rank tensor-parallel GPT-124M and sequence "
                    "parallelism on the one card, the TP shard route of "
                    "K5-K7, the lint; two pipeline stages, ZeRO-2 and its "
                    "checkpoint, MoE at ep = 2, the meta-optimizers); "
                    "prints no kernels line")
    ap.add_argument("--fluid", action="store_true",
                    help="phases 1 and 30 only (the build, the fluid "
                    "compat layer: the fluid ResNet-50 program, the PTB "
                    "StaticRNN LM, control flow, the torch GPT-124M "
                    "through fluid.io and a Predictor, the legacy "
                    "collective fleet); prints no kernels line")
    ap.add_argument("--incubate", action="store_true",
                    help="phases 1 and 31 only (the build, GPT-3 1.3B "
                    "trained under ASP 2:4, LookAhead and ModelAverage, "
                    "its decode, the kernels at its shapes, auto-checkpoint "
                    "resume, the small modules); prints no kernels line")
    ap.add_argument("--ckpt-child", nargs=2, metavar=("STOP", "DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--rnn", action="store_true",
                    help="phases 1 and 23 only (the build, the recurrent "
                    "surface and the LSTM encoder-decoder through "
                    "Model.fit and beam search); prints no kernels line")
    args = ap.parse_args()
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from paddle_tpu_torch import amp, nn, optimizer, regularizer
        from paddle_tpu_torch.ops import _build
        from paddle_tpu_torch.ops import attention as attn
        from paddle_tpu_torch.ops import fused_ce as tce
        from paddle_tpu_torch.ops import paged_attention as pa
        from paddle_tpu_torch.text.models import (GPTForCausalLM,
                                                  TransformerLMConfig)
    except ImportError as e:
        print(f"chip_smoke: paddle_tpu_torch not found beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    # full f32 products everywhere: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.ckpt_child:     # a child process of phase 31d
        return ckpt_child(torch, int(args.ckpt_child[0]),
                          args.ckpt_child[1])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; TF32 off for matmuls and "
          f"cuDNN")

    print("[1] build")
    parent_build = start_parent_build(_build, parent_sources(args.parent))
    secs = _build.build_all()
    for name in _build.sources():
        for line in ptxas_lines(_build.build_log(name)):
            print(f"  {name}: {line}")
    print(f"  built {_build.sources()} in {secs:.2f} s")
    blocks = _build.function("flash_bwd",
                             "flash_attention_backward_f32_blocks_per_sm",
                             [ctypes.c_int, ctypes.c_int])
    print("  f32 K2/K3 blocks an SM: " + ", ".join(
        f"D = {d}: {blocks(d, 0)} / {blocks(d, 1)}" for d in (64, 128)))
    k1_blocks = _build.function("flash_fwd",
                                "flash_attention_forward_f32_blocks_per_sm",
                                [ctypes.c_int, ctypes.c_int])
    print("  f32 K1 blocks an SM, by the warps that share 16 query rows (KS):"
          " " + ", ".join(f"D = {d}, KS = {ks}: {k1_blocks(d, ks)}"
                          for d, ks in ((64, 1), (64, 2), (64, 4), (128, 1),
                                        (128, 2))))
    ce_blocks = _build.function("fused_ce",
                                "fused_ce_backward_f32_blocks_per_sm",
                                [ctypes.c_int])
    k5_blocks = _build.function("fused_ce",
                                "fused_ce_forward_f32_blocks_per_sm", [])
    print(f"  f32 K5 blocks an SM: {k5_blocks()}; f32 K6/K7: "
          f"{ce_blocks(1)} / {ce_blocks(0)}")
    parent = load_parent(parent_build)
    print(f"  the parent's ({PARENT}) f32 K5: " + (
        "built, for phases 9 and 11" if parent else
        "no source at hand (no git history, no --parent): not compared"))

    cfg = TransformerLMConfig(dropout=0.0)
    prompts, max_new = workload(cfg.vocab_size)
    longest = max(len(p) + n for p, n in zip(prompts, max_new))

    train_cfg = TransformerLMConfig(tie_embeddings=False, dropout=0.0,
                                    use_flash_attention=True)
    train_shape = (8, train_cfg.num_heads, train_cfg.max_seq_len,
                   train_cfg.hidden_size // train_cfg.num_heads)
    if args.vision:
        print("[22] the vision surface: ResNet-50 config 2 (O2 bf16, "
              "batch 128), LeNet config 1")
        phase_vision(torch, amp)
        print(f"phases 1 and 22 in {time.perf_counter() - t_start:.1f} s")
        print(card_line())
        return 0
    if args.static:
        print("[24] jit.to_static: whole steps captured as CUDA graphs")
        bert24, flag24 = phase_static(torch, attn, tce, amp, optimizer,
                                      TransformerLMConfig)
        print("[25] dy2static and the static graph: Tensor control flow "
              "captured, the surface GPT through Executor.run")
        flag25, prog25 = phase_dy2static(torch, attn, tce, amp, optimizer,
                                         TransformerLMConfig)
        print(f"phases 1, 24 and 25 in {time.perf_counter() - t_start:.1f} "
              f"s; phase 24's captured launches: 24c K1/K2/K3 {bert24}, 24d "
              f"K1/K2/K3/K5/K6/K7 {flag24}; phase 25's: 25b "
              f"K1/K2/K3/K5/K6/K7 {flag25}, 25c K1/K2/K3 {prog25}")
        print(card_line())
        return 0
    if args.deploy:
        print("[26] deployment: jit.save, the Predictor in f32 and int8, "
              "QAT, onnx.export")
        big, small, qat, _ = phase_deploy(torch, attn, train_cfg)
        print(f"phases 1 and 26 in {time.perf_counter() - t_start:.1f} s; "
              f"phase 26's K1 launches: {big} at batch 8, {small} at batches "
              f"1 and 4; QAT's K1/K2/K3 {qat}")
        print(card_line())
        return 0
    if args.lazy:
        print("[27] the lazy eager executor: plain eager steps replayed "
              "as CUDA graphs")
        gpt27, bert27 = phase_lazy(torch, attn, amp, train_cfg)
        print(f"phases 1 and 27 in {time.perf_counter() - t_start:.1f} s; "
              f"phase 27's K1/K2/K3 launches: 27a {gpt27}, 27c {bert27}")
        print(card_line())
        return 0
    if args.dist:
        print("[28] the distributed layer: collectives, DataParallel, "
              "tensor and sequence parallelism, the lint")
        rows28, one = phase_dist(torch, amp, optimizer, attn, tce,
                                 TransformerLMConfig, GPTForCausalLM)
        print("[29] the rest of the distributed layer: two pipeline stages, "
              "ZeRO-2 and its sharded checkpoint, MoE at ep = 2, "
              "meta-optimizers")
        rows29 = phase_dist_rest(torch, optimizer, attn, tce,
                                 TransformerLMConfig, GPTForCausalLM, one)
        del one
        print(f"phases 1, 28 and 29 in {time.perf_counter() - t_start:.1f} "
              f"s; phases 28 and 29's launches: " + ", ".join(
                  f"{r['name']} {r['shape']} {r['launches']}"
                  for r in rows28 + rows29 if r["launches"]))
        print(card_line())
        return 0
    if args.fluid:
        print("[30] the fluid compat layer: ResNet-50 and the PTB LM as "
              "fluid programs, control flow, the torch GPT through fluid.io, "
              "the legacy fleet")
        rows30, legacy30 = phase_fluid(torch, attn, train_cfg)
        print(f"phases 1 and 30 in {time.perf_counter() - t_start:.1f} s; "
              f"phase 30's launches: 30d K1 " + ", ".join(
                  f"{r['shape']} {r['launches']}" for r in rows30)
              + f"; 30e K1/K2/K3 {legacy30}")
        print(card_line())
        return 0
    if args.incubate:
        print("[31] the last modules: GPT-3 1.3B under ASP 2:4, LookAhead "
              "and ModelAverage, its decode, the kernels at its shapes, "
              "auto-checkpoint, the small modules")
        rows31 = phase_incubate(torch, attn, tce, pa, amp, optimizer)
        print(f"phases 1 and 31 in {time.perf_counter() - t_start:.1f} s; "
              f"phase 31's launches: " + ", ".join(
                  f"{r['name']} {r['shape']} {r['launches']}"
                  for r in rows31))
        print(card_line())
        return 0
    if args.rnn:
        print("[23] the recurrent surface: the LSTM encoder-decoder "
              "(batch 128) through Model.fit, beam 10")
        phase_rnn(torch, amp)
        print(f"phases 1 and 23 in {time.perf_counter() - t_start:.1f} s")
        print(card_line())
        return 0
    if args.bert:
        print("[21] BERT-base pretraining and the Paddle surface's part B")
        bert = phase_bert(torch, attn, amp, optimizer)
        print(f"phases 1 and 21 in {time.perf_counter() - t_start:.1f} s; "
              f"phase 21's K1/K2/K3 launches (21b, 21c, 21d) {bert}")
        print(card_line())
        return 0
    if args.nn:
        print("[7] train GPT-124M (untied head)")
        _, phase7 = phase_train(torch, attn, train_cfg, optimizer, nn)
        print("[20] the Paddle nn surface: GPT-124M written in it, trained "
              "on the card")
        surface = phase_paddle_nn(torch, attn, train_cfg, optimizer, nn,
                                  phase7)
        print(f"phases 1, 7 and 20 in {time.perf_counter() - t_start:.1f} "
              f"s; phase 20's K1/K2/K3 launches {surface}")
        print(card_line())
        return 0
    if not args.fleet:
        print("[2] K4 paged decode attention vs plain")
        k4_row = phase_k4(torch, pa)
        print("[3] K1 flash-attention forward vs plain")
        k1_row, k1t_row = phase_k1(
            torch, attn, (1, cfg.num_heads, longest,
                          cfg.hidden_size // cfg.num_heads), train_shape,
            _build)
    print("[4] serve GPT-124M")
    gen = torch.Generator().manual_seed(1234)
    model = GPTForCausalLM(cfg, generator=gen).eval()
    reqs, k4, snap, wall = phase_serve(torch, model, prompts, max_new, pa,
                                       attn)
    if args.fleet:
        del model
        print("[16] the hardened engine and the router")
        k4_fleet, k1_fleet = phase_fleet(
            torch, pa, attn, TransformerLMConfig, prompts, max_new,
            [r.generated for r in reqs], snap["tokens_per_sec"], wall)
        print("[17] the observatories and the fleet telemetry")
        k4_obs, k1_obs = phase_observe(
            torch, pa, attn, TransformerLMConfig, prompts, max_new,
            [r.generated for r in reqs], snap["tokens_per_sec"])
        print("[18] the fleet over replica processes")
        k4_drill, k1_drill = phase_drill(
            torch, pa, attn, TransformerLMConfig, prompts, max_new,
            [r.generated for r in reqs], snap["tokens_per_sec"])
        print(f"phases 1, 4, 16, 17 and 18 in "
              f"{time.perf_counter() - t_start:.1f} s; phase 16's K4 "
              f"launches {k4_fleet}, K1 {k1_fleet}; phase 17's K4 "
              f"{k4_obs}, K1 {k1_obs}; phase 18's K4 {k4_drill}, K1 "
              f"{k1_drill}")
        print(card_line())
        return 0
    print("[5] greedy cross-check against the forward")
    k1 = phase_check(torch, model, reqs, attn)
    del model
    print("[6] K2/K3 flash-attention backward vs plain")
    (k2_row, k3_row, k1b_row, k2b_row, k3b_row,
     *noncausal) = phase_k2k3(torch, attn, train_shape)
    print("[7] train GPT-124M (untied head)")
    (k1_train, k2, k3), phase7 = phase_train(torch, attn, train_cfg,
                                             optimizer, nn)
    print("[8] card against CPU: 2-layer GPT at full width")
    for tie in (False, True):
        phase_card_vs_cpu(torch, optimizer, nn, TransformerLMConfig, tie)
    print("[9] K5/K6/K7 fused linear cross-entropy vs plain")
    (k5f_row, k6f_row, k7f_row, k5_row, k6_row,
     k7_row) = phase_k5k7(torch, tce, FLAGSHIP["batch"] * FLAGSHIP["seq"],
                          cfg.hidden_size, cfg.vocab_size, _build, parent)
    print("[10] the reference's flagship step: GPT-124M tied, AMP O1 bf16")
    flagship, flagship_losses, _, _ = phase_flagship(
        torch, attn, tce, amp, optimizer, TransformerLMConfig)
    print("[11] the flagship step in f32: GPT-124M tied, f32 K5-K7")
    tied_cfg = TransformerLMConfig(dropout=0.0, use_flash_attention=True,
                                   max_seq_len=FLAGSHIP["seq"])
    counts, f32_run = phase_tied_f32(torch, attn, tce, tied_cfg, optimizer,
                                     nn, _build, parent)
    wrappers = (attn.flash_attention_forward, attn.flash_bwd_dq,
                attn.flash_bwd_dkv, tce.fused_ce_forward, tce.fused_ce_bwd_dx,
                tce.fused_ce_bwd_dw)
    print("[12] the optimizers: 2-layer GPT at full width, card against CPU")
    optim = phase_optim(torch, wrappers, optimizer, nn, regularizer,
                        TransformerLMConfig)
    print("[13] recompute: phase 11's step, then 2 of phase 10's")
    rc_cfg = TransformerLMConfig(dropout=0.0, use_flash_attention=True,
                                 max_seq_len=FLAGSHIP["seq"], recompute=True)
    rc_f32, rc_bf16 = phase_recompute(
        torch, wrappers, rc_cfg, optimizer, nn, f32_run, amp, attn, tce,
        TransformerLMConfig, flagship_losses)
    print("[14] generate(): GPT-124M greedy and top-k, beams on 2 layers")
    k1_gen, k4_gen = phase_generate(torch, pa, attn, TransformerLMConfig)
    print("[15] serve the rest: slot pool, chunked prefill, speculative "
          "decoding, sampling, disaggregation")
    k4_rest = phase_rest(torch, pa, TransformerLMConfig, prompts, max_new,
                         [r.generated for r in reqs],
                         snap["tokens_per_sec"])
    print("[16] the hardened engine and the router: two replicas, a kill, "
          "chaos, the supervisor, HTTP")
    k4_fleet, k1_fleet = phase_fleet(
        torch, pa, attn, TransformerLMConfig, prompts, max_new,
        [r.generated for r in reqs], snap["tokens_per_sec"], wall)
    print("[17] the observatories (perf, cache, tenants, SLO, flight "
          "recorder, traces) and the fleet poller, rollup and server")
    k4_obs, k1_obs = phase_observe(
        torch, pa, attn, TransformerLMConfig, prompts, max_new,
        [r.generated for r in reqs], snap["tokens_per_sec"])
    print("[18] the fleet over replica processes: the router drill "
          "(monolithic and disaggregated), processes against threads, "
          "fleet_top, the lock patrol")
    k4_drill, k1_drill = phase_drill(
        torch, pa, attn, TransformerLMConfig, prompts, max_new,
        [r.generated for r in reqs], snap["tokens_per_sec"])
    print("[19] the Paddle-style eager core on the card")
    core = phase_core(torch, attn, train_shape)
    lazy_release(torch, "after phase 19")
    print("[20] the Paddle nn surface: GPT-124M written in it, trained on "
          "the card")
    surface = phase_paddle_nn(torch, attn, train_cfg, optimizer, nn, phase7)
    lazy_release(torch, "after phase 20")
    print("[21] BERT-base pretraining and the Paddle surface's part B: "
          "masked attention, config 3 eager, card against CPU, the "
          "TransformerEncoder, save/load, sparse grads, linalg")
    bert, bert_cpu, encoder = phase_bert(torch, attn, amp, optimizer)
    lazy_release(torch, "after phase 21")
    print("[22] the vision surface: ResNet-50's ops card against CPU, "
          "config 2 (ResNet-50, O2 bf16, Momentum, batch 128) with its "
          "profile, models card against CPU, config 1 (LeNet)")
    phase_vision(torch, amp)
    lazy_release(torch, "after phase 22")
    print("[23] the recurrent surface: its ops card against CPU, the LSTM "
          "encoder-decoder (batch 128) through Model.fit, beam decode, a "
          "small one card against CPU")
    phase_rnn(torch, amp)
    lazy_release(torch, "after phase 23")
    print("[24] jit.to_static: K1-K3 and K5-K7 inside graphs, configs 1-3 "
          "and the flagship captured against eager, the rules")
    bert24, flag24 = phase_static(torch, attn, tce, amp, optimizer,
                                  TransformerLMConfig)
    lazy_release(torch, "after phase 24")
    print("[25] dy2static and the static graph: dy2static's scenarios "
          "captured against the CPU, the flagship with a Tensor if, the "
          "surface GPT-124M through Executor.run, a leak attributed")
    flag25, prog25 = phase_dy2static(torch, attn, tce, amp, optimizer,
                                     TransformerLMConfig)
    lazy_release(torch, "after phase 25")
    print("[26] deployment: the surface GPT-124M through jit.save and "
          "create_predictor in f32 and int8, QAT, onnx.export, a changed "
          ".pdiparams")
    big26, small26, qat26, k1p_row = phase_deploy(torch, attn, train_cfg)
    lazy_release(torch, "after phase 26")
    print("[27] the lazy eager executor: the surface GPT-124M's plain "
          "eager loop replayed as one CUDA graph a step against the "
          "immediate path, LeNet and BERT-base, the edge cases, _C_ops "
          "and the profiler")
    gpt27, bert27 = phase_lazy(torch, attn, amp, train_cfg)
    lazy_release(torch, "after phase 27")
    print("[28] the distributed layer: a world of one over NCCL, the "
          "two-rank tensor-parallel GPT-124M and sequence parallelism on "
          "the one card, the TP shard route of K5-K7, the lint")
    rows28, one = phase_dist(torch, amp, optimizer, attn, tce,
                             TransformerLMConfig, GPTForCausalLM)
    print("[29] the rest of the distributed layer: GPT-124M in two pipeline "
          "stages and under ZeRO-2 on two rank processes started by the "
          "port's launcher, the ZeRO train state saved sharded and loaded "
          "by one process, MoE at ep = 2, GradientMerge and DGCMomentum")
    rows29 = phase_dist_rest(torch, optimizer, attn, tce,
                             TransformerLMConfig, GPTForCausalLM, one)
    del one
    lazy_release(torch, "after phase 29")
    print("[30] the fluid compat layer: the fluid ResNet-50 program through "
          "fluid.Executor against eager, the PTB StaticRNN LM card against "
          "CPU, While/cond/case/switch_case and arrays on the card, the "
          "torch GPT-124M through fluid.io, a Predictor and onnx.export, the "
          "legacy collective fleet")
    rows30, legacy30 = phase_fluid(torch, attn, train_cfg)
    lazy_release(torch, "after phase 30")
    print("[31] the last modules: GPT-3 1.3B (4 x 1024, O1 bf16) pruned 2:4 "
          "by ASP under LookAhead(AdamW) and ModelAverage, its greedy "
          "decode, K1-K7 at its shapes, auto-checkpoint resume across "
          "processes, softmax_mask_fuse, a host op, the CUDA RNG state")
    rows31 = phase_incubate(torch, attn, tce, pa, amp, optimizer)

    # launches summed over the main paths that run each row's kernel: K4
    # on phases 4, 14, 15's paged runs, 16 and 17, the serving K1 row on
    # phases 5, 14, 16 and 17 (the engine's prefill attends without K1,
    # so 16 and 17 add only what their stream checks run through the
    # forward); the f32 training rows
    # (K1 at the training shape, K2, K3, K5-K7) on phases 7, 11, 12 and
    # 13; the bf16 rows on phases 10 and 13
    k4_row["launches"] = (k4 + k4_gen + k4_rest + k4_fleet + k4_obs
                          + k4_drill)
    k1_row["launches"] = k1 + k1_gen + k1_fleet + k1_obs + k1_drill
    f32 = [a + b + c + d + e + f for a, b, c, d, e, f in
           zip(counts, optim, rc_f32, core + (0, 0, 0),
               surface + (0, 0, 0), prog25 + (0, 0, 0))]
    # phase 26: the Predictor's batch-8 runs and QAT's steps on the f32
    # training shape's rows; its batch-1 and batch-4 runs on their own row
    k1t_row["launches"] = (k1_train + f32[0] + big26 + qat26[0] + gpt27[0]
                           + legacy30[0])
    k2_row["launches"] = k2 + f32[1] + qat26[1] + gpt27[1] + legacy30[1]
    k3_row["launches"] = k3 + f32[2] + qat26[2] + gpt27[2] + legacy30[2]
    k1p_row["launches"] = small26
    k5f_row["launches"], k6f_row["launches"], k7f_row["launches"] = f32[3:]
    bf16 = [a + b + c + d for a, b, c, d in
            zip(flagship, rc_bf16, flag24, flag25)]
    for row, n in zip((k1b_row, k2b_row, k3b_row, k5_row, k6_row, k7_row),
                      bf16):
        row["launches"] = n
    # the non-causal rows (phase 6's timing) on phase 21's paths: no main
    # path runs f32 at BERT's [32,12,128,64]; 21c's card side runs
    # [2,12,128,64], BERT-base's steps (21b) the bf16 [32,12,128,64], the
    # encoder (21d) [8,12,512,64]
    bert = tuple(a + b + c for a, b, c in zip(bert, bert24, bert27))
    for i, counts in enumerate(((0, 0, 0), bert_cpu, bert, encoder)):
        for row, n in zip(noncausal[3 * i:3 * i + 3], counts):
            row["launches"] = n
    print(f"phases 1-31 in {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    keys = ("name", "route", "dtype", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: row[k] for k in keys + ("shape",)
                                   if k in row}
                                  for row in (k4_row, k1_row, k1t_row,
                                              k1p_row,
                                              k2_row, k3_row, k1b_row,
                                              k2b_row, k3b_row, k5_row,
                                              k6_row, k7_row, k5f_row,
                                              k6f_row, k7f_row,
                                              *noncausal, *rows28,
                                              *rows29, *rows30,
                                              *rows31)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
