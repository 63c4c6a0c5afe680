// dlopen demo of the native C ABI (native/capi/tpuembed.h) against the
// port's embedding server: the JAX package's examples/dylib.cpp, attached
// to a running server with tpe_connect.  The ABI's spawn mode
// (tpe_load_from_file) starts the JAX package's server, so this demo only
// connects; embedding_cpp_tpu_torch/examples/sample_dylib.py starts the
// port's server, builds the library and this demo, and runs it.
//
// Build:  g++ -O2 -o dylib_demo embedding_cpp_tpu_torch/examples/dylib.cpp -ldl
// Run:    ./dylib_demo LIB HOST PORT    (LIB: the built libtpuembed_capi.so)
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#include <vector>

typedef void* (*tpe_connect_fn)(const char*, int);
typedef void (*tpe_free_fn)(void*);
typedef int32_t (*tpe_n_embd_fn)(void*);
typedef int (*tpe_encode_batch_fn)(void*, int32_t, const char**, float*);
typedef const char* (*tpe_last_error_fn)(void*);
typedef int32_t (*tpe_index_fn)(void*, int32_t, const char**);
typedef int32_t (*tpe_search_fn)(void*, int32_t, const char**, int32_t, int32_t*, float*);

int main(int argc, char** argv) {
    if (argc < 4) {
        fprintf(stderr, "usage: %s LIB HOST PORT\n", argv[0]);
        return 1;
    }
    void* lib = dlopen(argv[1], RTLD_NOW);
    if (!lib) {
        fprintf(stderr, "dlopen failed: %s\n", dlerror());
        return 1;
    }
    auto connect = (tpe_connect_fn)dlsym(lib, "tpe_connect");
    auto free_ctx = (tpe_free_fn)dlsym(lib, "tpe_free");
    auto n_embd_fn = (tpe_n_embd_fn)dlsym(lib, "tpe_n_embd");
    auto encode_batch = (tpe_encode_batch_fn)dlsym(lib, "tpe_encode_batch");
    auto last_error = (tpe_last_error_fn)dlsym(lib, "tpe_last_error");
    if (!connect || !free_ctx || !n_embd_fn || !encode_batch || !last_error) {
        fprintf(stderr, "dlsym failed: %s\n", dlerror());
        return 1;
    }

    void* ctx = connect(argv[2], atoi(argv[3]));
    if (!ctx) {
        fprintf(stderr, "connect failed\n");
        return 1;
    }
    int32_t n_embd = n_embd_fn(ctx);
    printf("n_embd = %d\n", n_embd);

    const char* texts[] = {
        "Hello from the C ABI",
        "Embeddings over a GPU engine",
    };
    std::vector<float> out(2 * (size_t)n_embd);
    if (encode_batch(ctx, 2, texts, out.data()) != 0) {
        fprintf(stderr, "encode failed: %s\n", last_error(ctx));
        free_ctx(ctx);
        return 1;
    }
    for (int i = 0; i < 2; ++i) {
        printf("[%d] %-32s ->", i, texts[i]);
        for (int j = 0; j < 6 && j < n_embd; ++j) printf(" %+.6f", out[(size_t)i * n_embd + j]);
        printf(" ...\n");
    }

    // the server's on-device vector index: index a tiny corpus, query top-2
    // (only ids and scores come back over the socket)
    auto index_fn = (tpe_index_fn)dlsym(lib, "tpe_index");
    auto search_fn = (tpe_search_fn)dlsym(lib, "tpe_search");
    int rc = 0;
    if (index_fn && search_fn) {
        const char* corpus[] = {
            "The quick brown fox jumps over the lazy dog",
            "Quantum entanglement cannot transmit information",
            "A fast auburn fox leaps above the sleepy hound",
        };
        const char* query = "a speedy fox";
        int32_t idx[2];
        float scores[2];
        int32_t k = index_fn(ctx, 3, corpus) >= 3 ? search_fn(ctx, 1, &query, 2, idx, scores) : -1;
        if (k > 0) {
            printf("search %-24s ->", query);
            for (int j = 0; j < k; ++j) printf(" #%d(%.6f)", idx[j], scores[j]);
            printf("\n");
        } else {
            fprintf(stderr, "index/search failed: %s\n", last_error(ctx));
            rc = 1;
        }
    }
    free_ctx(ctx);
    dlclose(lib);
    return rc;
}
