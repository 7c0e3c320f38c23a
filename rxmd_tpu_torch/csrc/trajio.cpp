// trajio: the .xyz frame writer's formatting loop in C++ (the port's copy
// of native/trajio.cpp's trajio_write_xyz, which rxmd_tpu loads by ctypes).
//
// rxmd_tpu_torch.io.traj builds this file at first use with the host C++
// compiler into build/rxmd_tpu_torch/ and calls it by ctypes; the Python
// formatting of the same frame is traj.write_xyz_plain.
#include <cstdio>
#include <cstdint>
#include <cstring>

extern "C" {

// Write one reference-format .xyz frame (ref: fileio.F90:241-339).
// names: nt x 3 char array (space padded), types: 0-based per atom.
int trajio_write_xyz(const char* path, int append, int64_t n,
                     const double* cell6, const double* pos,
                     const double* q, const int32_t* types,
                     const int32_t* gid, const char* names, int64_t ntypes) {
    FILE* fh = fopen(path, append ? "a" : "w");
    if (!fh) return -1;
    fprintf(fh, "%9lld\n", (long long)n);
    fprintf(fh, "%12.5f%12.5f%12.5f%8.3f%8.3f%8.3f\n", cell6[0], cell6[1],
            cell6[2], cell6[3], cell6[4], cell6[5]);
    for (int64_t i = 0; i < n; ++i) {
        int t = types[i];
        if (t < 0 || t >= ntypes) t = 0;
        fprintf(fh, "%-3.3s%12.5f%12.5f%12.5f%8.3f%9d\n", names + 3 * t,
                pos[3 * i], pos[3 * i + 1], pos[3 * i + 2], q[i], gid[i]);
    }
    return fclose(fh) == 0 ? 0 : -1;
}

}  // extern "C"
